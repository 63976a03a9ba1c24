"""A copy of the benchmark in a temporary directory, with cells cut to a
size that a CPU test holds: 60 genes on one contig, 40 profiles and the
cluster accessions."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = {"genes": 60, "bank_subset": 40, "cluster_runs": [12]}


def make_copy(root):
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name in ("genome",):
        with open(os.path.join(root, "benchmark", "configs", f"{name}.json")) as f:
            config = json.load(f)
        config.update(TINY)
        with open(os.path.join(root, "benchmark", "configs", f"tiny_{name}.json"), "w") as f:
            json.dump(config, f)
        bench["configs"].append({"name": f"tiny_{name}", "source": "a test's cut",
                                 "file": f"benchmark/configs/tiny_{name}.json",
                                 "reduced": ["genes"], "why": "a CPU test"})
    bench["workloads"] += [
        {"name": "tiny_genome.run", "config": "tiny_genome", "traffic": "run", "chips": 1, "why": "t"},
        {"name": "tiny_genome.predict", "config": "tiny_genome", "traffic": "predict", "chips": 1,
         "why": "t"},
    ]
    for metric in bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] += ["tiny_" + w for w in metric["workloads"]]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def run_bench(root, *args, env=None):
    """``python -m benchmark.run`` in ``root`` on the CPU; ``(code, last
    line parsed or None, stderr)``."""
    full_env = dict(os.environ, **(env or {}))
    full_env["PYTHONPATH"] = os.pathsep.join([str(root), REPO])
    done = subprocess.run([sys.executable, "-m", "benchmark.run", "--device", "cpu", *args],
                          cwd=root, env=full_env, capture_output=True, text=True, timeout=900)
    lines = done.stdout.strip().splitlines()
    return done.returncode, (json.loads(lines[-1]) if lines else None), done.stderr


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return make_copy(str(tmp_path_factory.mktemp("bench")))
