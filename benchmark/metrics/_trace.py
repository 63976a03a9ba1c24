"""Reading a ``torch.profiler`` Chrome trace of one call (``--profile DIR``).

The traced window is the profiler's own span (its ``Trace`` event) less the
lead that ``gecco_tpu_torch.profiling.device_trace`` sleeps before the work;
device operations are the kernels, copies and fills that ran on the card.
"""

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

#: seconds that the program's ``device_trace`` waits before the traced work
TRACE_LEAD_S = 1.0
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, path: str) -> None:
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"]
        #: microseconds since the epoch of the trace's time origin
        self.origin_us = data.get("baseTimeNanoseconds", 0) / 1e3
        self.ops: List[Tuple[str, str, float, float]] = []   # (category, name, start us, dur us)
        self.span_us = 0.0
        self.session_us = 0.0
        for e in events:
            if e.get("ph") != "X":
                continue
            if e.get("cat") == "Trace" and float(e["dur"]) > self.span_us:
                self.span_us, self.session_us = float(e["dur"]), float(e["ts"])
            elif e.get("cat") in DEVICE_CATEGORIES:
                self.ops.append((e["cat"], e["name"], float(e["ts"]), float(e["dur"])))

    @classmethod
    def find(cls, directory: str) -> Optional["Trace"]:
        paths = sorted(glob.glob(os.path.join(directory, "*.pt.trace.json")))
        return cls(paths[-1]) if paths else None

    @property
    def window_s(self) -> float:
        return max(0.0, self.span_us / 1e6 - TRACE_LEAD_S)

    @property
    def session_s(self):
        """``(start, end)`` of the profiler's session, seconds since the epoch."""
        start = (self.origin_us + self.session_us) / 1e6
        return start, start + self.span_us / 1e6

    @property
    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran (the union)."""
        busy, end = 0.0, -float("inf")
        for _, _, start, dur in sorted(self.ops, key=lambda op: op[2]):
            stop = start + dur
            if stop > end:
                busy += stop - max(start, end)
                end = stop
        return busy / 1e6

    def kernels(self) -> List[Tuple[str, float]]:
        return [(name, dur / 1e6) for cat, name, _, dur in self.ops if cat == "kernel"]

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for _, name, _, dur in self.ops:
            out[name] = out.get(name, 0.0) + dur / 1e6
        return out

    @property
    def base_s(self) -> float:
        """Seconds since the epoch of the first device operation."""
        first = min((op[2] for op in self.ops), default=0.0)
        return (self.origin_us + first) / 1e6

    def gaps(self, limit: int = 10) -> List[Tuple[float, float]]:
        """The longest idle stretches inside the window: ``(start s, seconds)``
        from the first device operation."""
        ops = sorted(self.ops, key=lambda op: op[2])
        if not ops:
            return []
        origin, end, out = ops[0][2], ops[0][2], []
        for _, _, start, dur in ops:
            if start > end:
                out.append(((end - origin) / 1e6, (start - end) / 1e6))
            end = max(end, start + dur)
        return sorted(out, key=lambda g: -g[1])[:limit]
