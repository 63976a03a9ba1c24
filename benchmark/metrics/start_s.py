"""CLI and process start: a call's wall less the sum of its stage spans
(imports, CUDA context, argument parsing, table input and output).  In a
traced call the profiler's own time outside the spans is left out too: from
the call's start to the profiler's session, the session's lead, and from the
session's end to the call's end (the trace's export)."""

from ._trace import TRACE_LEAD_S


def read(run):
    values = []
    for call in run.calls:
        value = call.wall - sum(call.spans.values())
        if call.trace is not None and "began" in call.record:
            start, end = call.trace.session_s
            value -= (start - call.record["began"]) + TRACE_LEAD_S + (call.record["ended"] - end)
        values.append(value)
    return sum(values) / len(values) if values else None
