"""The device: the share of the search's stages (the union of the spans
``filter``, ``viterbi``, ``forward`` and ``domains``) in which no kernel,
copy or fill ran on the card, a mean over the traced calls.  The spans
and the trace share one clock (``time.time_ns()``, the trace's
``baseTimeNanoseconds + ts``).  A call with no device operation, as on
the CPU, gives no reading."""

from ._tree import covered, trees, union

STAGES = ("filter", "viterbi", "forward", "domains")


def read(run):
    values = []
    for call, tree in trees(run):
        if call.trace is None or not call.trace.ops:
            continue
        stages = union((s["start_ns"] / 1e3 - call.trace.origin_us,
                        s["end_ns"] / 1e3 - call.trace.origin_us)
                       for s in tree["spans"] if s["name"] in STAGES)
        total = sum(end - start for start, end in stages)
        if not total:
            continue
        busy = covered((max(start, a), min(start + dur, b))
                       for _, _, start, dur in call.trace.ops
                       for a, b in stages if start < b and start + dur > a)
        values.append(100.0 * (1.0 - busy / total))
    return sum(values) / len(values) if values else None
