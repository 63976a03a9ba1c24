"""The benchmark of ``gecco_tpu_torch``: seconds per ``gecco`` process.

    python -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1

A cell of ``BENCHMARK.json`` names a configuration
(``benchmark/configs/<config>.json``: the generator's sizes) and a traffic
mix (``benchmark/traffic/<traffic>.json``: the subcommand and its argument
template, the inputs it needs, the tables the reference judges, the limit of
each number compared).  Each per-layer metric is read by
``benchmark/metrics/<metric>.py``.  A run:

1. set-up: makes the inputs from ``--seed`` in a directory of its own under
   ``TMPDIR`` (the profile bank as ``.h3m``, the genome as FASTA, for
   ``predict`` the genes and features tables) and makes one warm-up call on
   a cut of them (``warm_config``: 64 genes on one contig, 64 profiles),
   which finds or builds the program's kernels in the checkout and reports
   whether the call saw the cards the cell needs.  Every call is a process
   of its own, so nothing else that a call warms outlives it;
2. the window: calls start back to back, each ``benchmark/child.py`` in a
   process of its own, while less than ``--seconds`` has passed; the last
   runs to its end.  With ``--trace 1`` each call adds ``--profile DIR``.
   The harness reads no table and no trace until the window has closed;
3. the judgement: every call's tables against the plain reference
   (``benchmark/reference/judge.py``), then one JSON line with ``correct``,
   ``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``
   when traced) and, last, ``checks``: each number compared beside its limit.

``--device cpu`` (tests only) skips the look for a card and runs the program
on the CPU; ``--child MODULE`` runs another entry in place of
``benchmark.child`` (the faults of ``benchmark/tests/fault_child.py``);
``--control`` replaces every judged answer by the reference's own in
bfloat16 before the judgement, and logs the program's own numbers beside.
``--seconds 1`` makes one call: the readings that the limits are set from.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

#: packages that no process of the benchmark may load, compared by whole
#: top-level name
BANNED = ("jax", "jaxlib", "flax", "gecco_tpu")
ROOT = os.getcwd()
HERE = os.path.dirname(os.path.abspath(__file__))
#: the warm-up call's cut of the configuration
WARM = {"genes": 64, "bank_subset": 64, "cluster_runs": [10]}


def warm_config(config: dict) -> dict:
    """The warm-up call's configuration: ``WARM``'s sizes where they are
    smaller, on one contig (an assembly's small contigs may have no room for
    ``WARM``'s cluster run; the warm-up builds kernels, which do not depend on
    the contigs)."""
    cut = {key: min(value, config.get(key, value)) if key != "cluster_runs" else value
           for key, value in WARM.items()}
    return {key: value for key, value in dict(config, **cut).items() if key != "contig_genes"}


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Call:
    """One process of the window: its wall, spans, record and trace."""

    def __init__(self, wall: float, record: dict, trace) -> None:
        self.wall = wall
        self.record = record
        self.trace = trace
        self.spans: Dict[str, float] = {}
        for name, seconds, _ in record.get("spans", []):
            self.spans[name] = self.spans.get(name, 0.0) + seconds


class Run:
    """What a per-layer metric reads: the calls and the run's inputs."""

    def __init__(self, calls: List[Call], inputs: dict) -> None:
        self.calls, self.inputs = calls, inputs


def load_cell(name: str):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    with open(os.path.join(HERE, "configs", cell["config"] + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return bench, cell, config, traffic


def card_facts() -> str:
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return done.stdout.strip() or done.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi: {err}"


def make_inputs(config: dict, traffic: dict, seed: int, work: str, bank=None):
    from .inputs import synthetic

    if bank is None:
        bank = synthetic.pfam_shaped_profiles(config["profiles"], seed=config["bank_seed"])
    if "bank_subset" in config:
        with open(os.path.join(HERE, "inputs", "cluster_domains.json")) as f:
            keep = {a for names in json.load(f).values() for a in names}
        bank = [gm for i, gm in enumerate(bank) if i < config["bank_subset"] or gm.accession in keep]
    if any(len(gm.stats) != 3 for gm in bank):
        raise SystemExit("the bank has no calibration (benchmark/inputs/calibration.npz)")
    genome = synthetic.make_genome(config, bank, seed)
    paths = {"fasta": os.path.join(work, "genome.fna"), "bank": os.path.join(work, "bank.h3m"),
             "genes": os.path.join(work, "given.genes.tsv"),
             "features": os.path.join(work, "given.features.tsv")}
    synthetic.write_fasta(paths["fasta"], genome)
    if "bank" in traffic["inputs"]:
        synthetic.write_h3m(paths["bank"], bank)
    if "features" in traffic["inputs"]:
        synthetic.write_predict_tables(paths["genes"], paths["features"], genome, bank, seed)
    return bank, genome, paths


def child_env(work: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    cache = os.path.join(ROOT, ".benchmark_cache")
    env.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    env.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    env["TMPDIR"] = work
    return env


def run_call(module: str, argv: List[str], record_path: str, env: dict, log_path: str):
    """One process; returns ``(wall seconds, record or None)``."""
    began = time.perf_counter()
    launched = time.time()
    with open(log_path, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", module, record_path, *argv],
                                cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT)
        try:
            proc.wait()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - began
    record = None
    if os.path.exists(record_path):
        with open(record_path) as f:
            record = json.load(f)
        record["exit"] = proc.returncode
        record["launched"] = launched
    return wall, record


def tail(path: str, size: int = 2000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-size:]


def per_layer(bench: dict, cell: dict) -> List[str]:
    return [m["name"] for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def end_to_end(bench: dict, cell: dict) -> List[dict]:
    return [m for m in bench["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="One run of a benchmark cell.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help=argparse.SUPPRESS)
    parser.add_argument("--child", default="benchmark.child", help=argparse.SUPPRESS)
    parser.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    bench, cell, config, traffic = load_cell(args.workload)
    if args.device == "cuda":
        log("card:", card_facts())
    log("host cpus:", os.cpu_count())

    work = tempfile.mkdtemp(prefix="gecco-bench-")
    try:
        return _run(args, bench, cell, config, traffic, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(args, bench, cell, config, traffic, work) -> int:
    from .metrics._trace import Trace
    from .reference.judge import Outputs, Reference

    bank, genome, paths = make_inputs(config, traffic, args.seed, work)
    log(f"inputs: {len(genome.contigs)} contigs, {genome.bp} bp, {len(genome.genes)} genes, "
        f"{len(bank)} profiles, {sum(gm.M for gm in bank)} nodes, G+C {genome.gc:.4f}, "
        f"longest protein {max(g.aa for g in genome.genes)} aa "
        f"({time.perf_counter() - _STARTED:.3f} s)")
    warm = os.path.join(work, "warm")
    os.mkdir(warm)
    _, _, warm_paths = make_inputs(warm_config(config), traffic, args.seed, warm, bank=bank)
    env = child_env(work)
    base = "genome"

    def argv_of(i: int, traced: bool, values: dict) -> List[str]:
        values = dict(values, out=os.path.join(work, f"call{i}"))
        argv = [part.format(**values) for part in traffic["argv"]]
        if args.device == "cpu":
            argv += traffic["cpu_argv"]
        if traced:
            argv += ["--profile", os.path.join(work, f"trace{i}")]
        return argv

    warm_wall, record = run_call(args.child, argv_of(0, False, warm_paths),
                                 os.path.join(work, "record0.json"), env,
                                 os.path.join(work, "log0.txt"))
    if record is None or record["exit"] != 0:
        log(f"the warm-up call failed ({warm_wall:.3f} s):\n" + tail(os.path.join(work, "log0.txt")))
        return 1
    if args.device == "cuda":
        available, count = record.get("cuda", (False, 0))
        if not available or count < cell["chips"]:
            log(f"needs {cell['chips']} CUDA device(s); torch.cuda.is_available() = "
                f"{available}, device_count() = {count}")
            return 2
    setup_s = time.perf_counter() - _STARTED
    log(f"warm-up call {warm_wall:.6f} s; setup_s {setup_s:.6f}")

    records: List[Optional[dict]] = []
    walls: List[float] = []
    window_start = time.perf_counter()
    while time.perf_counter() - window_start < args.seconds:
        i = len(walls) + 1
        wall, record = run_call(args.child, argv_of(i, bool(args.trace), paths),
                                os.path.join(work, f"record{i}.json"), env,
                                os.path.join(work, f"log{i}.txt"))
        walls.append(wall)
        records.append(record)
    window = time.perf_counter() - window_start

    calls: List[Call] = []
    outputs: List[Optional[Outputs]] = []
    failed_to_run = 0
    for i, (wall, record) in enumerate(zip(walls, records), 1):
        trace = Trace.find(os.path.join(work, f"trace{i}")) if args.trace else None
        log(f"call {i}: {wall:.6f} s, exit {None if record is None else record['exit']}"
            + ("" if record is None else
               f"; to cli.main {record['began'] - record['launched']:.3f} s, in it "
               f"{record['ended'] - record['began']:.3f} s, after it "
               f"{wall - (record['ended'] - record['launched']):.3f} s"))
        out = None
        if record is None or record["exit"] != 0:
            failed_to_run += 1
            log(tail(os.path.join(work, f"log{i}.txt")))
            record = record or {}
        else:
            try:
                out = Outputs.read(os.path.join(work, f"call{i}"), base)
            except (OSError, KeyError, ValueError) as err:
                log(f"call {i}: unreadable tables: {err}")
        calls.append(Call(wall, record, trace))
        outputs.append(out)

    loaded = {name.split(".")[0] for name in sys.modules}
    found = sorted(set(BANNED) & loaded)
    for call in calls:
        found += sorted(set(BANNED) & set(call.record.get("modules", [])))
    if found:
        log(f"modules that no process of the benchmark may load were loaded: {sorted(set(found))}")
        return 3
    peaks = [c.record.get("memory_peak_bytes", 0) for c in calls]
    kinds = {c.record.get("device") for c in calls if c.record.get("device")}

    # --- the judgement, once per distinct set of tables ---------------------
    reference = Reference(genome, bank, subcommand=traffic["subcommand"], seed=args.seed,
                          judged=traffic["judge"], features_path=paths["features"])
    limits = traffic["limits"]
    judged: Dict[tuple, Dict[str, float]] = {}
    worst: Dict[str, float] = {}
    failed = failed_to_run
    t_judge = time.perf_counter()
    for out in outputs:
        if out is None:
            continue
        key = out.key()
        if key not in judged:
            if args.control:
                for name, value in sorted(reference.judge(out).items()):
                    log(f"program's own {name}: {value!r}")
            judged[key] = reference.judge(reference.control(out) if args.control else out)
        numbers = judged[key]
        for name, value in numbers.items():
            worst[name] = max(worst.get(name, -math.inf), value)
        if any(not value <= limits[name] for name, value in numbers.items()):
            failed += 1
    failed += sum(1 for out in outputs if out is None) - failed_to_run
    for note in reference.notes:
        log("judgement:", note)
    log(f"judged {len(judged)} distinct table set(s) of {len(outputs)} call(s) in "
        f"{time.perf_counter() - t_judge:.3f} s")

    attempted = len(calls)
    metrics: Dict[str, dict] = {}
    device = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "kind": sorted(kinds)[0] if kinds else "cpu", "count": cell["chips"],
              "memory_peak_bytes": max(peaks) if peaks else 0}
    result = {"correct": failed == 0 and attempted > 0, "attempted": attempted, "failed": failed}
    if not args.trace:
        units = {m["name"]: m["unit"] for m in end_to_end(bench, cell)}
        values = {"call_s": window / attempted, "setup_s": setup_s}
        metrics = {name: {"value": values[name], "unit": units[name]} for name in units}
    else:
        traced = [c.trace for c in calls if c.trace is not None]
        device["busy_s"] = sum(t.busy_s for t in traced)
        device["window_s"] = sum(t.window_s for t in traced)
        launches = sum(c.record.get("launches", {}).get("ssv_filter", 0) for c in calls)
        from .metrics import _roofline, ssv_roofline_pct

        seen = sum(1 for t in traced for name, _ in t.kernels()
                   if ssv_roofline_pct.KERNEL.search(name))
        log(f"trace completeness: kernel A launches in the traces {seen} of {launches} counted; "
            f"{sum(len(t.kernels()) for t in traced)} kernels in {len(traced)} trace(s)")
        log(f"tracing overhead: traced calls {window / attempted:.6f} s each, against the "
            f"untraced runs' call_s")
        residues = [(g.end - g.start + 1) // 3 - 1 for g in genome.genes]
        run = Run(calls, {"residues": residues, "nodes": [gm.M for gm in bank]})
        log("roofline peak:", _roofline.PEAK_SOURCE)
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        for name in per_layer(bench, cell):
            value = importlib.import_module(f"benchmark.metrics.{name}").read(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        ops: Dict[str, float] = {}
        for t in traced:
            for name, seconds in t.seconds_by_name().items():
                ops[name] = ops.get(name, 0.0) + seconds
        gaps = []
        for c in calls:
            if c.trace is None:
                continue
            base_s = c.trace.base_s
            for start, seconds in c.trace.gaps():
                at = base_s + start + seconds / 2
                stage = next((name for name, dur, end in c.record.get("spans", [])
                              if end - dur <= at <= end), "outside the stage spans")
                gaps.append([stage, seconds])
        result["breakdown"] = {
            "device_ops": [[n[:200], s] for n, s in sorted(ops.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": sorted(gaps, key=lambda g: -g[1])[:10],
        }
    result["metrics"] = metrics
    result["device"] = device
    result["checks"] = {name: {"value": worst[name], "limit": limits[name]} for name in sorted(worst)}
    for name in sorted(worst):
        log(f"check {name}: {worst[name]!r} (limit {limits[name]!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
