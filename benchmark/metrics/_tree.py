"""Reading the program's span tree.  With ``--profile DIR`` the program
writes ``gecco_tpu_torch.profiling.TIMER.export()`` (spans with
``start_ns`` and ``end_ns`` on the clock of ``time.time_ns()``, and the
counters) to ``DIR/spans.json`` beside its trace.  The harness gives each
traced call ``DIR = <work>/trace<i>``, with ``<work>`` a ``gecco-bench-*``
directory under this process's temporary directory; a tree belongs to the
call whose ``began``..``ended`` (the child's clock around ``cli.main``)
holds its spans, the import's aside.  A call whose program wrote no tree
gives no reading."""

import glob
import json
import os
import tempfile

SPANS_FILE = "spans.json"
#: nanoseconds of slack for ``began`` and ``ended``, floats of ``time.time()``
SLACK_NS = 1000


def _written():
    pattern = os.path.join(tempfile.gettempdir(), "gecco-bench-*", "trace*", SPANS_FILE)
    found = []
    for path in glob.glob(pattern):
        try:
            with open(path) as f:
                tree = json.load(f)
        except (OSError, ValueError):
            continue
        spans = tree.get("spans", [])
        imported = set()
        for s in spans:                  # parents come before their children
            if (s["name"] == "import" and s["parent"] is None) or s["parent"] in imported:
                imported.add(s["id"])
        inside = [s for s in spans if s["id"] not in imported]
        if inside:
            found.append((min(s["start_ns"] for s in inside),
                          max(s["end_ns"] for s in inside), tree))
    return found


def trees(run):
    """``(call, tree)`` for each call of ``run`` whose program wrote a tree."""
    found = _written()
    out = []
    for call in run.calls:
        if "began" not in call.record or "ended" not in call.record:
            continue
        began = call.record["began"] * 1e9 - SLACK_NS
        ended = call.record["ended"] * 1e9 + SLACK_NS
        for start, end, tree in found:
            if began <= start and end <= ended:
                out.append((call, tree))
                break
    return out


def span_seconds(tree, names):
    return sum(s["end_ns"] - s["start_ns"] for s in tree["spans"] if s["name"] in names) / 1e9


def mean_spans(run, *names):
    """Mean seconds a call of the spans ``names``, over the calls that have one."""
    values = [span_seconds(tree, names) for _, tree in trees(run)
              if any(s["name"] in names for s in tree["spans"])]
    return sum(values) / len(values) if values else None


def union(intervals):
    """``intervals`` merged where they overlap, in order."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def covered(intervals):
    return sum(end - start for start, end in union(intervals))
