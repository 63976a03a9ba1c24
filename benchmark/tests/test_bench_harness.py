"""The harness: its last line, names, lookup by name and the modules it loads."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from .conftest import REPO, make_copy, run_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", ["tiny_genome.run", "tiny_genome.predict"])
def test_cpu_run_prints_the_contract_line(tiny, cell):
    code, line, err = run_bench(tiny, "--workload", cell, "--seed", str(2**31 + 3),
                                "--seconds", "1", "--trace", "0")
    assert code == 0, err
    assert set(line) == KEYS
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, err
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"call_s", "setup_s"}
    assert line["device"]["platform"] == "cpu"
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert err.strip().splitlines()[-1].startswith("check ")


def test_cpu_traced_run_reads_the_span_metrics(tiny):
    code, line, err = run_bench(tiny, "--workload", "tiny_genome.run", "--seed", "8",
                                "--seconds", "1", "--trace", "1")
    assert code == 0, err
    assert set(line) == KEYS | {"breakdown"}
    for name in ("start_s", "genes_s", "annotate_s", "crf_s", "clusters_s"):
        assert line["metrics"][name]["value"] > 0
    assert "ssv_roofline_pct" not in line["metrics"]      # no kernel A on the CPU
    assert line["device"]["window_s"] > 0


def test_names_keep_to_the_contract():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
        assert os.path.exists(os.path.join(REPO, "benchmark", "traffic", w["traffic"] + ".json"))
    for c in bench["configs"]:
        assert 0 < len(c["source"]) <= 200 and os.path.exists(os.path.join(REPO, c["file"]))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics", m["name"] + ".py"))
    assert {m["name"] for m in bench["end_to_end"]} == {"call_s", "setup_s"}


def test_files_added_are_found_by_name(tmp_path):
    root = make_copy(str(tmp_path))
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    base = os.path.join(root, "benchmark")
    shutil.copy(os.path.join(base, "configs", "tiny_genome.json"),
                os.path.join(base, "configs", "added.json"))
    shutil.copy(os.path.join(base, "traffic", "predict.json"),
                os.path.join(base, "traffic", "added_mix.json"))
    with open(os.path.join(base, "metrics", "calls_seen.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.calls))\n")
    bench["configs"].append({"name": "added", "source": "t", "file": "benchmark/configs/added.json",
                             "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "added.added_mix", "config": "added", "traffic": "added_mix",
                               "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "calls_seen", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "t", "moves": "call_s",
                               "workloads": ["added.added_mix"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    code, line, err = run_bench(root, "--workload", "added.added_mix", "--seed", "4",
                                "--seconds", "1", "--trace", "1")
    assert code == 0, err
    assert line["metrics"]["calls_seen"]["value"] == line["attempted"]


def _top_level(code, env=None):
    done = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                           "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                          cwd=REPO, capture_output=True, text=True, env=env, timeout=300)
    assert done.returncode == 0, done.stderr
    return set(json.loads(done.stdout.strip().splitlines()[-1]))


def test_no_process_loads_jax_or_the_jax_package(tmp_path):
    harness = _top_level("import benchmark.run, benchmark.reference.judge, benchmark.metrics._trace")
    assert not harness & {"jax", "jaxlib", "flax", "gecco_tpu", "gecco_tpu_torch"}
    reference = _top_level("import benchmark.reference.judge, benchmark.reference.crf")
    assert not reference & {"jax", "gecco_tpu", "gecco_tpu_torch"}
    record = tmp_path / "record.json"
    done = subprocess.run([sys.executable, "-m", "benchmark.child", str(record), "--version"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    modules = set(json.loads(record.read_text())["modules"])
    assert "gecco_tpu_torch" in modules
    assert not modules & {"jax", "jaxlib", "flax", "gecco_tpu"}


def test_without_the_program_the_run_fails(tmp_path):
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "genome.predict",
                           "--seed", "1", "--seconds", "1", "--device", "cpu"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert done.returncode != 0
    assert done.stdout.strip() == ""


@pytest.mark.cuda
def test_one_call_on_the_card(tmp_path):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    done = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "genome.predict",
                           "--seed", "3", "--seconds", "1"],
                          cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert done.returncode == 0, done.stderr[-4000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


#: a cell that uses every optional key of a configuration at a size a CPU
#: test holds: two contigs of 30 genes, one protein of the tail past 4,096
#: residues with four planted modules, a GC-rich codon choice and spacers
MIXED = {"genes": 60, "bank_subset": 40, "cluster_runs": [12],
         "contig_genes": {"median": 30, "sigma": 0.0, "min": 20},
         "protein_tail": {"share": 0.02, "aa": [4200, 4400], "module_aa": 1000},
         "gc3": 0.9, "spacer_gc": 0.7}


def test_cpu_run_of_a_cell_with_every_optional_key(tmp_path):
    root = make_copy(str(tmp_path))
    base = os.path.join(root, "benchmark")
    with open(os.path.join(base, "configs", "genome.json")) as f:
        config = json.load(f)
    config.update(MIXED)
    with open(os.path.join(base, "configs", "mixed.json"), "w") as f:
        json.dump(config, f)
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "mixed", "source": "t", "file": "benchmark/configs/mixed.json",
                             "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "mixed.run", "config": "mixed", "traffic": "run",
                               "chips": 1, "why": "t"})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    code, line, err = run_bench(root, "--workload", "mixed.run", "--seed", str(2**31 + 77),
                                "--seconds", "1", "--trace", "0")
    assert code == 0, err
    assert line["correct"] is True, err
    assert "inputs: 2 contigs" in err
    assert re.search(r"longest protein (\d+) aa", err) and \
        int(re.search(r"longest protein (\d+) aa", err).group(1)) > 4096
    assert "(1 of the protein tail)" in err, err
