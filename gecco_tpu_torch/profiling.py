"""Step timing and the PyTorch profiler hook.

The reference ships no tracing or profiling at all — its only
instrumentation is rich progress bars driven by per-stage callbacks
(``gecco/cli/_log.py:96-108``; SURVEY §5.1).  The port keeps the JAX
package's two primitives:

* :class:`StageTimer` — wall-clock accounting of every pipeline stage,
  reported by the CLI at ``-vv``;
* :func:`device_trace` — wraps a command in a ``torch.profiler`` trace
  (``--profile DIR``), written as a Perfetto/TensorBoard-readable
  Chrome trace of the host's operators and of every kernel launched on
  the card (the twin of ``gecco_tpu.profiling.xla_trace``).

The timer keeps the reference's callback-style progress contract
intact: it is orthogonal to the per-stage ``progress`` callbacks
threaded through the layers (as in ``gecco/orf.py:93``,
``gecco/hmmer/__init__.py:101``).
"""

import contextlib
import functools
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

__all__ = ["StageTimer", "TIMER", "timed", "device_trace"]

#: seconds between opening a trace and the work it records: the first
#: launches of a trace were seen to go unrecorded on the card
TRACE_LEAD_S = 1.0


class StageTimer:
    """Accumulates named wall-clock stage durations in call order."""

    def __init__(self) -> None:
        self.records: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.records.append((name, time.perf_counter() - start))

    def summary(self) -> Dict[str, Tuple[int, float]]:
        """Aggregate ``{stage: (calls, total_seconds)}`` preserving order."""
        out: Dict[str, Tuple[int, float]] = {}
        for name, seconds in self.records:
            calls, total = out.get(name, (0, 0.0))
            out[name] = (calls + 1, total + seconds)
        return out

    def reset(self) -> None:
        self.records.clear()


#: Process-wide timer used by the CLI pipeline stages.
TIMER = StageTimer()


def timed(name: str) -> Callable:
    """Decorator recording the wall time of every call under ``name``."""

    def decorate(function: Callable) -> Callable:
        @functools.wraps(function)
        def wrapper(*args, **kwargs):
            with TIMER.stage(name):
                return function(*args, **kwargs)

        return wrapper

    return decorate


@contextlib.contextmanager
def device_trace(logdir: Optional[str]) -> Iterator[None]:
    """Trace the host's operators, and every kernel on the card when one is
    present, into ``logdir`` (nothing when it is None or empty).

    A throwaway trace opens and closes first, and the recorded work starts
    ``TRACE_LEAD_S`` seconds into the trace, since a trace was seen to drop
    its first launches.  The trace is written by
    ``torch.profiler.tensorboard_trace_handler`` as ``*.pt.trace.json``.
    """
    if not logdir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities):
        torch.zeros(1024).sum()
        if torch.cuda.is_available():
            torch.zeros(1024, device="cuda").sum()
            torch.cuda.synchronize()
    handler = torch.profiler.tensorboard_trace_handler(str(logdir))
    with torch.profiler.profile(activities=activities, on_trace_ready=handler):
        time.sleep(TRACE_LEAD_S)
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
