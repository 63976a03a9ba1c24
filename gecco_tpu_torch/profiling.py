"""Spans, counters and the PyTorch profiler hook.

The reference ships no tracing or profiling at all — its only
instrumentation is rich progress bars driven by per-stage callbacks
(``gecco/cli/_log.py:96-108``; SURVEY §5.1).  The port has one tracer
and one profiler hook:

* :class:`StageTimer` (:data:`TIMER`) — a tree of spans with counters.
  Each span has an id, its parent (the innermost span open on the same
  thread), a name, and start and end as ``time.time_ns()``, the clock
  of the profiler's Chrome trace (``baseTimeNanoseconds + ts``).  The
  five pipeline stages (:meth:`StageTimer.stage`, :func:`timed`) also
  append ``(name, seconds)`` to :attr:`StageTimer.records`; other spans
  (:meth:`StageTimer.span`, also a decorator) enter the tree only.  While
  a profiler is on, a span also enters ``torch.profiler.record_function``,
  so the tree shows in the trace beside the kernels; with the profiler
  off a span makes no torch call.  Spans time the host: none waits on
  the device.  The CLI prints the tree and the counters at ``-vv``;
  :meth:`StageTimer.export` hands them to a caller as plain data;
* :func:`device_trace` — wraps a command in a ``torch.profiler`` trace
  (``--profile DIR``), written as a Perfetto/TensorBoard-readable
  Chrome trace of the host's operators, the spans, and every kernel
  launched on the card (the twin of ``gecco_tpu.profiling.xla_trace``),
  and beside it the tree and the counters as JSON (:data:`SPANS_FILE`).

The timer keeps the reference's callback-style progress contract
intact: it is orthogonal to the per-stage ``progress`` callbacks
threaded through the layers (as in ``gecco/orf.py:93``,
``gecco/hmmer/__init__.py:101``).
"""

import contextlib
import functools
import itertools
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

__all__ = ["Span", "StageTimer", "TIMER", "timed", "device_trace", "write_tree"]

#: seconds between opening a trace and the work it records: the first
#: launches of a trace were seen to go unrecorded on the card
TRACE_LEAD_S = 1.0
#: the span of the process's imports, which :meth:`StageTimer.reset` keeps
IMPORT = "import"
#: the file in a ``--profile`` directory that holds :meth:`StageTimer.export`
SPANS_FILE = "spans.json"


class Span:
    """One timed interval of the tree; ``end_ns`` is None while it is open."""

    __slots__ = ("id", "parent", "name", "device", "start_ns", "end_ns")

    def __init__(self, id: int, parent: Optional[int], name: str,
                 device: Optional[str]) -> None:
        self.id, self.parent, self.name, self.device = id, parent, name, device
        self.start_ns = time.time_ns()
        self.end_ns: Optional[int] = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _profiler_on():
    """``torch`` when a profiler is recording, else None (and no torch call)."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.autograd.profiler._is_profiler_enabled:
        return torch
    return None


class StageTimer:
    """The process's span tree, its counters, and the stage records."""

    def __init__(self) -> None:
        #: ``(stage, seconds)`` of every stage, in the order they ended
        self.records: List[Tuple[str, float]] = []
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def current(self) -> Optional[Span]:
        """The innermost span open on this thread (or the one it was attached to)."""
        local = self._local
        stack = getattr(local, "stack", None)
        return stack[-1] if stack else getattr(local, "base", None)

    def begin(self, name: str) -> Span:
        """Open a span that no other span nests in, and that enters no
        ``record_function``: one that outlives the block or the profiler
        it starts in; :meth:`finish` closes it."""
        parent = self.current()
        with self._lock:
            span = Span(next(self._ids), parent and parent.id, name,
                        getattr(self._local, "device", None))
            self.spans.append(span)
        return span

    @staticmethod
    def finish(span: Span) -> None:
        span.end_ns = time.time_ns()

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[Span]:
        """A span of the tree around the block, or around each call of the
        function it decorates (not a stage record)."""
        span = self.begin(name)
        local = self._local
        if getattr(local, "stack", None) is None:
            local.stack = []
        local.stack.append(span)
        try:
            torch = _profiler_on()
            if torch is None:
                yield span
            else:
                with torch.profiler.record_function(name):
                    yield span
        finally:
            self.finish(span)
            local.stack.pop()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[Span]:
        """A span that is also recorded as ``(name, seconds)`` in :attr:`records`."""
        with self.span(name) as span:
            yield span
        self.records.append((name, span.seconds))

    @contextlib.contextmanager
    def attach(self, parent: Optional[Span], device: Optional[str] = None) -> Iterator[None]:
        """Spans opened on this thread in the block nest under ``parent``
        (a span of the thread that started this one) and name ``device``."""
        local = self._local
        saved = (getattr(local, "stack", None), getattr(local, "base", None),
                 getattr(local, "device", None))
        local.stack, local.base, local.device = [], parent, device
        try:
            yield
        finally:
            local.stack, local.base, local.device = saved

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def reset(self) -> None:
        """Clear the records, counters and spans, except the import span and
        the spans under it, which the process records once."""
        self.records.clear()
        with self._lock:
            kept = set()
            for span in self.spans:          # parents come before their children
                if (span.name == IMPORT and span.parent is None) or span.parent in kept:
                    kept.add(span.id)
            self.spans = [span for span in self.spans if span.id in kept]
            self.counters = {}

    def export(self) -> dict:
        """The closed spans and the counters, as plain data."""
        with self._lock:
            spans = [span for span in self.spans if span.end_ns is not None]
            counters = dict(self.counters)
        return {
            "clock": "unix_ns",
            "spans": [{"id": s.id, "parent": s.parent, "name": s.name, "device": s.device,
                       "start_ns": s.start_ns, "end_ns": s.end_ns} for s in spans],
            "counters": counters,
        }

    def report(self) -> List[str]:
        """The tree, one line a name under its parents' names (indented),
        with its calls, total and self seconds, then the counters.  Self
        time is a span's own less the union of its children's within it."""
        tree = self.export()
        spans = {s["id"]: s for s in tree["spans"]}
        children: Dict[Optional[int], List[dict]] = {}
        for s in tree["spans"]:
            parent = s["parent"] if s["parent"] in spans else None
            children.setdefault(parent, []).append(s)
        rows: Dict[tuple, List[float]] = {}   # path -> [calls, total, self], in order

        def visit(s: dict, path: tuple) -> None:
            label = s["name"] + (f" [{s['device']}]" if s["device"] else "")
            path = path + (label,)
            covered, last = 0, s["start_ns"]
            for start, end in sorted((max(c["start_ns"], s["start_ns"]),
                                      min(c["end_ns"], s["end_ns"]))
                                     for c in children.get(s["id"], [])):
                if end > last:
                    covered += end - max(start, last)
                    last = end
            row = rows.setdefault(path, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += (s["end_ns"] - s["start_ns"]) / 1e9
            row[2] += (s["end_ns"] - s["start_ns"] - covered) / 1e9
            for c in sorted(children.get(s["id"], []), key=lambda c: c["start_ns"]):
                visit(c, path)

        for s in sorted(children.get(None, []), key=lambda s: s["start_ns"]):
            visit(s, ())
        lines = [f"timing: {'  ' * (len(path) - 1)}{path[-1]}: {total:.3f}s "
                 f"({calls} call{'s' if calls != 1 else ''}, self {own:.3f}s)"
                 for path, (calls, total, own) in rows.items()]
        lines += [f"counter: {name}: {value}" for name, value in sorted(tree["counters"].items())]
        return lines


#: Process-wide timer used by the CLI pipeline stages.
TIMER = StageTimer()


def timed(name: str) -> Callable:
    """Decorator recording every call as the stage ``name``."""

    def decorate(function: Callable) -> Callable:
        @functools.wraps(function)
        def wrapper(*args, **kwargs):
            with TIMER.stage(name):
                return function(*args, **kwargs)

        return wrapper

    return decorate


def write_tree(logdir: str) -> None:
    """Write :meth:`StageTimer.export` of :data:`TIMER` to ``logdir/SPANS_FILE``."""
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, SPANS_FILE), "w") as f:
        json.dump(TIMER.export(), f)


@contextlib.contextmanager
def device_trace(logdir: Optional[str]) -> Iterator[None]:
    """Trace the host's operators and the spans, and every kernel on the
    card when one is present, into ``logdir`` (nothing when it is None or
    empty).

    A throwaway trace opens and closes first, and the recorded work starts
    ``TRACE_LEAD_S`` seconds into the trace, since a trace was seen to drop
    its first launches: both are the span ``profiler``.  The trace is
    written by ``torch.profiler.tensorboard_trace_handler`` as
    ``*.pt.trace.json``; the wait for the card and the writing are the
    span ``export-trace``.  Last, :func:`write_tree` writes the spans, the
    import's included, and the counters beside the trace, also when the
    command raised.
    """
    if not logdir:
        yield
        return
    lead = TIMER.begin("profiler")
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
    export = None
    try:
        with torch.profiler.profile(activities=activities, on_trace_ready=handler):
            time.sleep(TRACE_LEAD_S)
            TIMER.finish(lead)
            try:
                yield
            finally:
                export = TIMER.begin("export-trace")
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
    finally:
        if export is not None:
            TIMER.finish(export)
        write_tree(str(logdir))
