"""The metrics that read the program's span tree (``spans.json`` in the
``--profile`` directory of a traced call)."""

import importlib
import json
import os
import subprocess
import sys
import tempfile

import pytest

from ..run import Call, Run
from .conftest import REPO, run_bench

#: the metrics that read the tree's spans, and what the harness read before it
SPAN_METRICS = ("import_s", "files_s", "unspanned_s", "bank_s", "search_s")
STAGE_METRICS = ("start_s", "genes_s", "annotate_s")


def test_cpu_traced_run_reads_the_tree(tiny):
    code, line, err = run_bench(tiny, "--workload", "tiny_genome.run", "--seed", str(2**31 + 11),
                                "--seconds", "1", "--trace", "1")
    assert code == 0, err
    assert line["correct"] is True, err
    for name in SPAN_METRICS + STAGE_METRICS:
        assert line["metrics"][name]["value"] > 0, name
    assert "search_idle_pct" not in line["metrics"]      # no device operation on the CPU


def _child(tmp_path, patch=""):
    """One traced ``benchmark.child`` call whose command fails at once (a
    missing genome), with its ``--profile`` directory where the harness puts
    it, under a ``gecco-bench-*`` directory; ``patch`` runs first.  Returns
    the record it wrote."""
    record = tmp_path / "record.json"
    trace = tmp_path / "gecco-bench-test" / "trace1"
    argv = ["run", "-g", str(tmp_path / "missing.fna"), "-o", str(tmp_path / "out"),
            "--device", "cpu", "--profile", str(trace)]
    script = (f"{patch}\nimport runpy, sys\nsys.argv = ['child', {str(record)!r}, *{argv!r}]\n"
              "runpy.run_module('benchmark.child', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and record.exists(), done.stderr
    with open(record) as f:
        return json.load(f)


@pytest.mark.parametrize("program", ["tree", "no tree"])
def test_child_and_metrics_without_a_tree(tmp_path, monkeypatch, program):
    """A program that writes no ``spans.json`` (the port before the tree)
    gives no reading of any tree metric; one that does is read back for
    the call whose clock holds it."""
    from ..metrics import _tree

    patch = ("import gecco_tpu_torch.profiling as p\np.write_tree = lambda logdir: None"
             if program == "no tree" else "")
    record = _child(tmp_path, patch)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    run = Run([Call(1.0, record, None)], {})
    for name in SPAN_METRICS + ("search_idle_pct",):
        value = importlib.import_module(f"benchmark.metrics.{name}").read(run)
        if program == "no tree" or name in ("bank_s", "search_s", "search_idle_pct"):
            assert value is None, name
    found = _tree.trees(run)
    assert len(found) == (program == "tree")
    if program == "tree":
        names = [s["name"] for s in found[0][1]["spans"]]
        assert names[:2] == ["import", "import-torch"]
        assert "profiler" in names and "export-trace" in names
        shifted = dict(record, began=record["ended"] + 1, ended=record["ended"] + 2)
        assert _tree.trees(Run([Call(1.0, shifted, None)], {})) == []
