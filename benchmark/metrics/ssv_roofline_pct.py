"""Kernel A's share of its roofline: the least time of the SSV filter over
every pair of the call's proteins and the bank (``_roofline``), over the
device time of kernel A's launches in the call's trace.  A call whose trace
lacks one of the launches that the program counted, or one of the bank's
width classes, gives no reading."""

import re

from . import _roofline

KERNEL = re.compile(r"\bssv_kernel(_wide)?<")


def read(run):
    shares = []
    bound = _roofline.ssv_bound_s(run.inputs["residues"], run.inputs["nodes"])
    want = _roofline.classes(run.inputs["nodes"])
    for call in run.calls:
        if call.trace is None:
            continue
        launches = [(name, s) for name, s in call.trace.kernels() if KERNEL.search(name)]
        counted = call.record.get("launches", {}).get("ssv_filter")
        if not launches or len({name for name, _ in launches}) < want or counted != len(launches):
            continue
        shares.append(100.0 * bound / sum(s for _, s in launches))
    return sum(shares) / len(shares) if shares else None
