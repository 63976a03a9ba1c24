"""Device milliseconds per call, summed over every kernel in the trace."""


def read(run):
    traced = [call.trace for call in run.calls if call.trace is not None]
    if not traced:
        return None
    return 1e3 * sum(sum(s for _, s in t.kernels()) for t in traced) / len(traced)
