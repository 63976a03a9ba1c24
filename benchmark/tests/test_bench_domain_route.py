"""The metrics of the domain stage's routes (``domains_s``,
``host_domains_s``, ``host_pairs``) on trees written by hand: a program
that counts the routes, and one from before the counters, which has the
``domains`` span and the ``host_pairs`` counter only."""

import json
import tempfile

import pytest

from ..metrics import domains_s, host_domains_s, host_pairs
from ..run import Call, Run

S = 1_000_000_000  # nanoseconds a second


def _write(root, i, began, spans, counters):
    """``spans.json`` of traced call ``i`` under a ``gecco-bench-*``
    directory, its spans ``(name, parent index, start s, end s)`` after
    ``began``; the call's record."""
    trace = root / "gecco-bench-test" / f"trace{i}"
    trace.mkdir(parents=True)
    tree = {"clock": "unix_ns", "counters": counters, "spans": [
        {"id": k + 1, "parent": None if parent is None else parent + 1, "name": name,
         "device": None, "start_ns": int((began + start) * S), "end_ns": int((began + end) * S)}
        for k, (name, parent, start, end) in enumerate(spans)]}
    (trace / "spans.json").write_text(json.dumps(tree))
    return {"began": began, "ended": began + 10.0}


@pytest.mark.parametrize("program", ["routes", "before the routes"])
def test_route_metrics(tmp_path, monkeypatch, program):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    routes = program == "routes"
    extra = {"host_pairs.length": 1, "host_pairs.overflow": 2, "domains.long_rows": 9}
    records = [
        _write(tmp_path, 1, 100.0, [("annotate-domains", None, 1.0, 8.0),
                                    ("domains", 0, 2.0, 6.0),
                                    ("host-engine", 1, 2.5, 3.5),
                                    ("host-engine", 1, 4.0, 4.5)],
               dict({"host_pairs": 3}, **(extra if routes else {}))),
        _write(tmp_path, 2, 200.0, [("annotate-domains", None, 1.0, 8.0),
                                    ("domains", 0, 2.0, 3.0)],
               dict({"host_pairs": 0}, **(dict.fromkeys(extra, 0) if routes else {}))),
    ]
    run = Run([Call(10.0, record, None) for record in records], {})
    assert domains_s.read(run) == pytest.approx((4.0 + 1.0) / 2)
    assert host_pairs.read(run) == pytest.approx(1.5)
    if routes:   # the second call reads 0: its tree counts the routes, none to the host
        assert host_domains_s.read(run) == pytest.approx((1.0 + 0.5 + 0.0) / 2)
    else:
        assert host_domains_s.read(run) is None


def test_route_metrics_without_a_tree(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    run = Run([Call(10.0, {"began": 1.0, "ended": 2.0}, None)], {})
    assert domains_s.read(run) is None
    assert host_domains_s.read(run) is None
    assert host_pairs.read(run) is None
