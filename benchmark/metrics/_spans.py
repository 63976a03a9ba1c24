"""Mean seconds per call of the program's stage spans (``profiling.TIMER``)."""


def mean_span(run, *names):
    values = [sum(call.spans.get(name, 0.0) for name in names)
              for call in run.calls if any(name in call.spans for name in names)]
    return sum(values) / len(values) if values else None
