"""Share of the traced windows (after the profiler's lead) in which no
operation ran on the card, over every traced call."""


def read(run):
    traced = [call.trace for call in run.calls if call.trace is not None]
    window = sum(t.window_s for t in traced)
    if not window:
        return None
    return 100.0 * (1.0 - sum(t.busy_s for t in traced) / window)
