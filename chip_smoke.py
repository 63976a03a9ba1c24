#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port end to end on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (each prints its wall seconds, each ends in a device sync):

1. device: require CUDA, print the card's name and power limit, build
   the kernels from ``gecco_tpu_torch/csrc``;
2. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the main path's shapes (2,766 Pfam-shaped profiles plus one
   of 2,100 nodes), with a stated tolerance, timed beside it;
3. search: ``SearchPipeline(backend="cuda").search`` at the benchmark
   shape (a 3,230-gene synthetic genome, ~3,000 called proteins cut to
   512 residues with planted domains, 2,766 profiles calibrated by the
   port's own ``calibrate``), launch counts of every kernel, the
   survivor funnel, and the same search on plain PyTorch for the first
   proteins as a reference;
4. CLI: ``gecco-tpu-torch run`` on the genome with the calibrated bank
   written as ``.h3m`` (accessions renamed to the embedded model's
   Pfam whitelist).

The search of phase 3 runs under ``torch.profiler`` (device activity
only), which gives each kernel's device milliseconds and the card's
idle share of the search.  The line before the last is a JSON object
describing each kernel; the last line is ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero before that line.  JAX is blocked
from import: the port and this script must run without it.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None  # any import of JAX fails

import numpy
import torch

N_PROFILES = 2766
GENOME_GENES = 3230
WIDE_NODES = 2100
TOL = {"ssv_filter": 1e-4, "viterbi_pairs": 1e-4, "forward_pairs": 1e-3}
REPLACES = {
    "ssv_filter": ("gecco_tpu_torch/csrc/ssv.cu", "gecco_tpu/hmm/kernels.py:643"),
    "viterbi_pairs": ("gecco_tpu_torch/csrc/viterbi.cu", "gecco_tpu/hmm/kernels.py:1312"),
    "forward_pairs": ("gecco_tpu_torch/csrc/forward.cu", "gecco_tpu/hmm/stream.py:1047"),
}
#: name of each wrapper's ``__global__`` function (templates add ``<W>``)
GLOBALS = {"ssv_filter": "ssv_kernel", "viterbi_pairs": "viterbi_kernel",
           "forward_pairs": "forward_kernel"}


def require(condition, message):
    """Fail the run (``assert`` would vanish under ``python -O``)."""
    if not condition:
        raise RuntimeError(message)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"# phase {self.name}: start", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, kind, value, tb):
        torch.cuda.synchronize()
        print(f"# phase {self.name}: {time.perf_counter() - self.t0:.3f} s"
              + ("" if kind is None else " FAILED"), flush=True)
        return False


def timed_ms(fn, repeats):
    """Mean milliseconds of ``fn()`` on the card (CUDA events), after a warm-up."""
    result = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return result, start.elapsed_time(end) / repeats


def phase_kernels(device, report):
    import warnings

    from gecco_tpu_torch.hmm.bank import TorchBank
    from gecco_tpu_torch.hmm.kernels import (
        SeqPack, ssv_filter, ssv_filter_plain, viterbi_pairs, viterbi_pairs_plain)
    from gecco_tpu_torch.hmm.stream import forward_pairs, forward_pairs_plain
    from gecco_tpu_torch.hmm.synthetic import (
        pfam_shaped_profiles, synthetic_profiles, synthetic_proteins)

    profiles = pfam_shaped_profiles(N_PROFILES, seed=0)
    profiles += synthetic_profiles(1, min_length=WIDE_NODES, max_length=WIDE_NODES, seed=9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bank = TorchBank.build(profiles, device)
    lengths = bank.lengths.cpu().numpy()
    seqs = [x[:512] for x in synthetic_proteins(64, mean_length=280, seed=3)]
    pack = SeqPack(seqs, device)
    print(f"# kernel bank: P={bank.P} Mp={bank.Mp} widths="
          f"{[(w, int(i.numel())) for w, i in bank.classes]}; {len(seqs)} proteins, "
          f"{int(pack.lens_host.sum())} residues", flush=True)

    got, ms = timed_ms(lambda: ssv_filter(pack, bank), 5)
    want, plain_ms = timed_ms(lambda: ssv_filter_plain(pack, bank), 1)
    report("ssv_filter", got, want, ms, plain_ms)

    # survivor-like pairs: every protein against random profiles, plus
    # every protein against the wide profile
    rng = numpy.random.default_rng(5)
    s_idx = numpy.concatenate([rng.integers(0, len(seqs), 4032), numpy.arange(len(seqs))])
    p_idx = numpy.concatenate([rng.integers(0, N_PROFILES, 4032),
                               numpy.full(len(seqs), bank.P - 1)])
    print(f"# pair kernels: {len(s_idx)} pairs, "
          f"{int(sum(lengths[p] * pack.lens_host[s] for s, p in zip(s_idx, p_idx)))} cells",
          flush=True)
    got, ms = timed_ms(lambda: viterbi_pairs(pack, bank, s_idx, p_idx), 3)
    want, plain_ms = timed_ms(lambda: viterbi_pairs_plain(pack, bank, s_idx, p_idx), 1)
    report("viterbi_pairs", got, want, ms, plain_ms)
    got, ms = timed_ms(lambda: forward_pairs(pack, bank, s_idx, p_idx), 3)
    want, plain_ms = timed_ms(lambda: forward_pairs_plain(pack, bank, s_idx, p_idx), 1)
    report("forward_pairs", got, want, ms, plain_ms)


def phase_search(device, state):
    from gecco_tpu_torch import _build
    from gecco_tpu_torch.hmm.calibrate import calibrate
    from gecco_tpu_torch.hmm.pipeline import SearchPipeline
    from gecco_tpu_torch.hmm.synthetic import bench_workload

    t0 = time.perf_counter()
    genome, profiles, seqs = bench_workload(GENOME_GENES, N_PROFILES)
    print(f"# workload: {len(genome)} bp, {len(seqs)} proteins "
          f"({sum(map(len, seqs))} residues) x {len(profiles)} profiles "
          f"in {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    calibrate(profiles, device=device)
    torch.cuda.synchronize()
    print(f"# calibrate (port, kernels): {time.perf_counter() - t0:.3f} s", flush=True)

    pipeline = SearchPipeline(profiles, device=device, Z=N_PROFILES, domZ=N_PROFILES,
                              backend="cuda")
    _ = pipeline.bank  # upload outside the timed search
    torch.cuda.synchronize()
    _build.reset_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        hits = pipeline.search(seqs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(_build.launches)
    device_ms = {}
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = event.self_cuda_time_total
        if us:
            device_ms[event.key] = us / 1e3
    busy = sum(device_ms.values())
    per_kernel = {name: sum(ms for key, ms in device_ms.items() if fn in key)
                  for name, fn in GLOBALS.items()}
    print(f"# device ms (profiler) {json.dumps(per_kernel)}; all device work "
          f"{busy!r} ms of {seconds * 1e3!r} ms, idle share "
          f"{1 - busy / (seconds * 1e3)!r}", flush=True)
    print(f"# search: {seconds:.3f} s, {len(hits)} hits, "
          f"{sum(len(h.domains) for h in hits)} domains", flush=True)
    print(f"# stage_counts {json.dumps(pipeline.stage_counts)}", flush=True)
    print(f"# stage_seconds {json.dumps(pipeline.stage_seconds)}", flush=True)
    print(f"# stage_cells {json.dumps(pipeline.stage_cells)}", flush=True)
    print(f"# launches {json.dumps(launches)}", flush=True)
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched by the search")
    for stage in ("F1", "F2", "F3", "reported"):
        require(pipeline.stage_counts.get(stage, 0) > 0, f"empty funnel at {stage}")
    for h in hits:
        require(numpy.isfinite(h.score) and h.domains, f"malformed hit {h}")

    # reference: the same search on the plain PyTorch versions, first proteins
    head = seqs[:48]
    plain = SearchPipeline(profiles, device=device, Z=N_PROFILES, domZ=N_PROFILES,
                           backend="torch")
    a, b = pipeline.search(head), plain.search(head)
    require(pipeline.stage_counts == plain.stage_counts,
            f"funnel {pipeline.stage_counts} != plain {plain.stage_counts}")
    require([(h.sequence_index, h.profile.name) for h in a]
            == [(h.sequence_index, h.profile.name) for h in b], "hits differ from plain")
    for x, y in zip(a, b):
        require(abs(x.score - y.score) <= 5e-3, f"score {x.score} != plain {y.score}")
        require([(d.ienv, d.jenv) for d in x.domains] == [(d.ienv, d.jenv) for d in y.domains],
                "domain envelopes differ from plain")
    print(f"# reference (plain torch, {len(head)} proteins): {len(b)} hits agree, "
          f"stage_counts {json.dumps(plain.stage_counts)}", flush=True)
    state.update(genome=genome, profiles=profiles, launches=launches)


def phase_cli(device, state):
    from gecco_tpu_torch.cli import main
    from gecco_tpu_torch.hmm.synthetic import write_library

    with tempfile.TemporaryDirectory() as tmp:
        bank_path = os.path.join(tmp, "bank.h3m")
        write_library(bank_path, state["profiles"])
        genome_path = os.path.join(tmp, "genome.fna")
        with open(genome_path, "w") as f:
            f.write(">genome\n")
            genome = state["genome"]
            for i in range(0, len(genome), 80):
                f.write(genome[i : i + 80] + "\n")
        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        code = main(["run", "-g", genome_path, "--hmm", bank_path, "-o", out,
                     "--device", device.type, "--force-tsv"])
        print(f"# cli run: exit {code} in {time.perf_counter() - t0:.3f} s", flush=True)
        require(code == 0, f"gecco-tpu-torch run exited {code}")
        counts = {}
        for kind in ("genes", "features", "clusters"):
            path = os.path.join(out, f"genome.{kind}.tsv")
            require(os.path.exists(path), f"missing {path}")
            with open(path) as f:
                counts[kind] = sum(1 for _ in f) - 1
        print(f"# cli tables: {counts['genes']} genes, {counts['features']} domains, "
              f"{counts['clusters']} clusters", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    device = torch.device("cuda:0")
    kernels = {}
    state = {}

    def report(name, got, want, ms, plain_ms):
        got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
        require(got.shape == want.shape and numpy.isfinite(got).all(), f"{name}: bad output")
        err = float(numpy.abs(got - want).max())
        print(f"# kernel {name}: max_abs_err {err!r} (tol {TOL[name]}) "
              f"kernel {ms!r} ms, plain {plain_ms!r} ms", flush=True)
        require(err <= TOL[name], f"{name} disagrees with its plain version: {err}")
        kernels[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    with Phase("1 device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}", flush=True)
        from gecco_tpu_torch import _build

        t0 = time.perf_counter()
        _build.library()
        print(f"# kernels built in {time.perf_counter() - t0:.3f} s", flush=True)
    with Phase("2 kernels"):
        phase_kernels(device, report)
    with Phase("3 search"):
        phase_search(device, state)
    with Phase("4 cli"):
        phase_cli(device, state)

    loaded = sorted(name for name, module in sys.modules.items()
                    if module is not None and name.split(".")[0] == "jax")
    require(not loaded, f"JAX was imported: {loaded}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": REPLACES[name][0],
         "replaces": REPLACES[name][1], "launches": state["launches"][name],
         **kernels[name]}
        for name in REPLACES
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
