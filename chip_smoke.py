#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port end to end on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (each prints its wall seconds, each ends in a device sync):

1. device: require CUDA, print the card's name and power limit, build
   the kernels from ``gecco_tpu_torch/csrc``;
2. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the main path's shapes (2,766 Pfam-shaped profiles plus one
   of 2,100 nodes), with a stated tolerance, timed beside it; the
   domain kernels D-G over 256 proteins with planted domains against
   their planted profiles (the bank's width classes in turn) and against
   the wide profile, one launch per width class as the search makes
   them, and over the envelope rows those pairs yield (every class has
   rows); the dense kernel H in both semirings over 32 proteins against
   the whole bank (every width class, 128 to 4,096 nodes), and against
   kernels C and B on the same pairs;
3. search: ``SearchPipeline(backend="cuda").search`` at the benchmark
   shape (a 3,230-gene synthetic genome, ~3,000 called proteins cut to
   512 residues with planted domains, 2,766 profiles calibrated by the
   port's own ``calibrate``), launch counts of every kernel, the
   survivor funnel, the pairs whose domains the host engine defined,
   peak device memory, and the same search on plain PyTorch for the
   first proteins as a reference;
4. max-filter search: ``SearchPipeline(max_filter=True,
   backend="cuda").search`` (hmmsearch ``--max``) over the same
   workload, every pair Forward-scored by kernel H: its funnel, launch
   counts, the candidates that reach domain definition, peak device
   memory, its hits against the default search's (a superset) and
   against the same search on plain PyTorch for the first proteins;
5. CLI: ``gecco-tpu-torch run`` on the genome with the calibrated bank
   written as ``.h3m`` (accessions renamed to the embedded model's
   Pfam whitelist).

The searches of phases 3 and 4 run under ``torch.profiler`` (device
activity only), which gives each kernel's device milliseconds and the
card's idle share of the search; the launch counts are set to 0 just
before each search and read just after it.  The line before the last
is a JSON object describing each kernel (its launches on the search
that runs it, its error against the plain version, its time, the plain
version's time and its bound); the last line is ``{"ok": true,
"device": {...}}``.  Any failure exits non-zero before that line.  JAX
and the JAX package are blocked from import: the port and this script
must run without them.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None  # any import of JAX fails
sys.modules["gecco_tpu"] = None  # and of the JAX package

import numpy
import torch

N_PROFILES = 2766
GENOME_GENES = 3230
WIDE_NODES = 2100
DOMAIN_PROTEINS = 256
#: proteins of the dense kernel's check against its plain version
DENSE_PROTEINS = 32
#: the survivor funnel of the search through F3 (``stage_counts``)
FUNNEL = {"pairs": 8339490, "F1": 417790, "F2": 31893, "F3": 1800}
#: absolute tolerances (nats, or probabilities): max-plus kernels are
#: exact up to their order of maxima; sum-product kernels and their log
#: scales sum in another order than the plain versions; trajectories,
#: posteriors and null2 log-ratios likewise
TOL = {"ssv_filter": 1e-4, "viterbi_pairs": 1e-4, "forward_pairs": 1e-3,
       "trajectory": 1e-4, "log_scale": 1e-3, "logn2": 1e-3,
       "dense_forward": 1e-3, "dense_viterbi": 1e-4}
#: kernel H against kernels C and B (the same functions by other
#: recurrences: per-pair blocks, and B in log space)
CROSS_TOL = 5e-3
#: relative tolerance of the bfloat16 planes: one bfloat16 step (2^-7 of
#: the value at the bottom of a binade), where float32 values that differ
#: in their last bits round apart
PLANE_RTOL = 2.0 ** -7
REPLACES = {
    "ssv_filter": ("gecco_tpu_torch/csrc/ssv.cu", "gecco_tpu/hmm/kernels.py:643"),
    "viterbi_pairs": ("gecco_tpu_torch/csrc/viterbi.cu", "gecco_tpu/hmm/kernels.py:1312"),
    "forward_pairs": ("gecco_tpu_torch/csrc/forward.cu", "gecco_tpu/hmm/stream.py:1047"),
    "posterior_fwd": ("gecco_tpu_torch/csrc/stream_fwd.cu", "gecco_tpu/hmm/stream.py:60"),
    "posterior_bwd": ("gecco_tpu_torch/csrc/stream_bwd.cu", "gecco_tpu/hmm/stream.py:216"),
    "align_bwd": ("gecco_tpu_torch/csrc/align_bwd.cu", "gecco_tpu/hmm/stream.py:395"),
    "align_fwd": ("gecco_tpu_torch/csrc/align_fwd.cu", "gecco_tpu/hmm/stream.py:568"),
    "dense_scores": ("gecco_tpu_torch/csrc/dense.cu", "gecco_tpu/hmm/kernels.py:1051"),
}
#: name of each wrapper's ``__global__`` function (templates add ``<W>``)
GLOBALS = {"ssv_filter": "ssv_kernel", "viterbi_pairs": "viterbi_kernel",
           "forward_pairs": "forward_kernel", "posterior_fwd": "posterior_fwd_kernel",
           "posterior_bwd": "posterior_bwd_kernel", "align_bwd": "align_bwd_kernel",
           "align_fwd": "align_fwd_kernel", "dense_scores": "dense_kernel"}
#: the kernels of each search: the default path (phase 3) and max_filter (phase 4)
DEFAULT_PATH = ("ssv_filter", "viterbi_pairs", "forward_pairs", "posterior_fwd",
                "posterior_bwd", "align_bwd", "align_fwd")
MAX_FILTER_PATH = ("dense_scores", "posterior_fwd", "posterior_bwd", "align_bwd", "align_fwd")
#: the least time of a kernel's work (``bound_ms``): the larger of its float
#: operations over the H100 SXM's float32 peak outside the tensor cores and
#: its bytes (each input read once, each output written once) over the HBM
#: rate (NVIDIA's data sheet, at the 700 W limit)
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: float operations per DP cell (one residue against one node) of each
#: recurrence: A = emission minus loop, entry max, add, running max; B = the
#: max-plus M/I/D updates (11) and the prefix-max delete chain (3) and E (1);
#: C, D and H's Forward = the sum-product updates (11), delete chain (3),
#: E sum (2), rescale (3), H's Viterbi one fewer (E a max of M alone); E and
#: F = the Backward step with its delete chain and rescale; G = the Forward
#: and the envelope Forward (2 x 19), posteriors (6) and the optimal-accuracy
#: DP (20)
FLOPS_PER_CELL = {"ssv_filter": 4, "viterbi_pairs": 15, "forward_pairs": 19,
                  "posterior_fwd": 19, "posterior_bwd": 24, "align_bwd": 24,
                  "align_fwd": 64, "dense_forward": 19, "dense_viterbi": 18}
#: float32 planes a Forward/Backward kernel reads per node of a profile
#: (21 emission rows and 8 transitions)
PLANES = 29


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


def bound(flops, nbytes):
    """``bound_ms`` and ``bound_by`` of work of ``flops`` and ``nbytes``."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def pair_work(pack, lengths, s_idx, p_idx, per_cell, out_bytes, planes=PLANES):
    """``(flops, bytes)`` of a recurrence over pairs ``(s_idx[r], p_idx[r])``:
    the DP cells of this run's sequences and models, each sequence's
    residues and each profile's rows read once, the int32 pair indices and
    ``out_bytes`` of outputs."""
    s_idx, p_idx = numpy.asarray(s_idx), numpy.asarray(p_idx)
    cells = float((pack.lens_host[s_idx].astype(numpy.float64) * lengths[p_idx]).sum())
    nbytes = (float(pack.lens_host[numpy.unique(s_idx)].sum())
              + 4.0 * planes * float(lengths[numpy.unique(p_idx)].sum())
              + 8.0 * len(s_idx) + out_bytes)
    return cells * per_cell, nbytes


def all_pairs_work(pack, lengths, per_cell, planes=PLANES):
    """``(flops, bytes)`` of a recurrence over every pair of the pack and
    the bank (its ``[S, P]`` float32 scores written once)."""
    cells = float(pack.lens_host.sum()) * float(lengths.sum())
    nbytes = (float(pack.lens_host.sum()) + 4.0 * planes * float(lengths.sum())
              + 4.0 * pack.S * len(lengths))
    return cells * per_cell, nbytes


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
    report("ssv_filter", [("ssv_filter", got, want)], ms, plain_ms,
           all_pairs_work(pack, lengths, FLOPS_PER_CELL["ssv_filter"], planes=21))

    # survivor-like pairs: every protein against random profiles, plus
    # every protein against the wide profile
    rng = numpy.random.default_rng(5)
    s_idx = numpy.concatenate([rng.integers(0, len(seqs), 4032), numpy.arange(len(seqs))])
    p_idx = numpy.concatenate([rng.integers(0, N_PROFILES, 4032),
                               numpy.full(len(seqs), bank.P - 1)])
    print(f"# pair kernels: {len(s_idx)} pairs, "
          f"{int(sum(lengths[p] * pack.lens_host[s] for s, p in zip(s_idx, p_idx)))} cells",
          flush=True)
    for name, kernel, plain in (("viterbi_pairs", viterbi_pairs, viterbi_pairs_plain),
                                ("forward_pairs", forward_pairs, forward_pairs_plain)):
        got, ms = timed_ms(lambda: kernel(pack, bank, s_idx, p_idx), 3)
        want, plain_ms = timed_ms(lambda: plain(pack, bank, s_idx, p_idx), 1)
        report(name, [(name, got, want)], ms, plain_ms,
               pair_work(pack, lengths, s_idx, p_idx, FLOPS_PER_CELL[name], 4.0 * len(s_idx)))
    phase_dense_kernel(device, bank, seqs[:DENSE_PROTEINS], report)
    phase_domain_kernels(device, profiles, bank, report)


def phase_dense_kernel(device, bank, seqs, report):
    """Kernel H in both semirings against its plain version, every width
    class of the bank, and against kernels C and B on the same pairs."""
    from gecco_tpu_torch.hmm.kernels import (
        SeqPack, dense_scores, dense_scores_plain, viterbi_pairs)
    from gecco_tpu_torch.hmm.stream import forward_pairs

    pack = SeqPack(seqs, device)
    lengths = bank.lengths.cpu().numpy()
    print(f"# dense kernel: {pack.S} proteins x {bank.P} profiles, classes "
          f"{[w for w, _ in bank.classes]}", flush=True)
    s_idx = numpy.repeat(numpy.arange(pack.S), bank.P)
    p_idx = numpy.tile(numpy.arange(bank.P), pack.S)
    checks, timings = [], {}
    for semiring, pair_kernel in (("forward", forward_pairs), ("viterbi", viterbi_pairs)):
        viterbi = semiring == "viterbi"
        got, ms = timed_ms(lambda: dense_scores(pack, bank, viterbi=viterbi), 3)
        want, plain_ms = timed_ms(lambda: dense_scores_plain(pack, bank, viterbi=viterbi), 1)
        checks.append((f"dense_{semiring}", got, want))
        timings[semiring] = (ms, plain_ms, all_pairs_work(
            pack, lengths, FLOPS_PER_CELL[f"dense_{semiring}"]))
        cross = pair_kernel(pack, bank, s_idx, p_idx).view(pack.S, bank.P)
        err = float((cross - got).abs().max())
        print(f"# kernel dense_scores ({semiring}) against the pair kernel: max abs "
              f"{err!r} (tol {CROSS_TOL})", flush=True)
        require(err <= CROSS_TOL, f"dense {semiring} disagrees with the pair kernel: {err}")
    ms, plain_ms, work = timings["forward"]
    v_ms, v_plain_ms, v_work = timings["viterbi"]
    report("dense_scores", checks, ms, plain_ms, work,
           viterbi_ms=v_ms, viterbi_plain_ms=v_plain_ms,
           viterbi_bound_ms=bound(*v_work)["bound_ms"])


def phase_domain_kernels(device, profiles, bank, report):
    """Kernels D-G against their plain versions, one launch per width class."""
    from gecco_tpu_torch.hmm import stream
    from gecco_tpu_torch.hmm.kernels import SeqPack
    from gecco_tpu_torch.hmm.synthetic import plant_domain, synthetic_proteins

    rng = numpy.random.default_rng(6)
    seqs = [x[:512] for x in synthetic_proteins(DOMAIN_PROTEINS, mean_length=280, seed=4)]
    # each protein gets a profile of the benchmark bank planted, the
    # bank's width classes in turn, so that every class the search
    # launches is held against the plain versions
    bench_class = bank.class_of[:N_PROFILES]
    members = [numpy.flatnonzero(bench_class == w) for w in sorted(set(bench_class.tolist()))]
    planted = numpy.array([members[i % len(members)][(13 * i) % len(members[i % len(members)])]
                           for i in range(len(seqs))])
    for i, p in enumerate(planted):
        seqs[i] = plant_domain(seqs[i], profiles[p], rng, max_len=min(150, profiles[p].M))
    pack = SeqPack(seqs, device)
    s_all = numpy.tile(numpy.arange(len(seqs)), 2)
    p_all = numpy.concatenate([planted, numpy.full(len(seqs), bank.P - 1)])
    width = bank.class_of[p_all]
    classes = sorted(set(width.tolist()))
    require(classes == sorted(set(bank.class_of.tolist())),
            f"domain kernels: classes {classes} miss some of the bank's")
    groups = [(s_all[width == w], p_all[width == w]) for w in classes]
    print(f"# domain kernels: {len(s_all)} pairs, per class "
          f"{[(int(w), int((width == w).sum())) for w in classes]}", flush=True)

    lengths = bank.lengths.cpu().numpy()

    def run(fn, plain, arg_lists, repeats):
        """Outputs of kernel and plain version per launch; summed mean ms of each."""
        ms = plain_ms = 0.0
        outs = []
        for args in arg_lists:
            got, t = timed_ms(lambda: fn(pack, bank, *args), repeats)
            want, t_plain = timed_ms(lambda: plain(pack, bank, *args), 1)
            ms += t
            plain_ms += t_plain
            outs.append((got, want))
        return outs, ms, plain_ms

    def work(name, arg_lists, outs, in_bytes=lambda args: 0.0, cells_to=None):
        """Summed ``(flops, bytes)`` of the launches: each row's cells (to
        ``cells_to(args)`` residues where given, else its length), rows
        and inputs read once, outputs (the kernel's tensors) written once."""
        flops = nbytes = 0.0
        for args, (got, _want) in zip(arg_lists, outs):
            s_idx, p_idx = args[0], args[1]
            out_bytes = sum(float(t.numel() * t.element_size())
                            for t in (got if isinstance(got, tuple) else (got,)))
            f, b = pair_work(pack, lengths, s_idx, p_idx, FLOPS_PER_CELL[name],
                             out_bytes + in_bytes(args))
            if cells_to is not None:
                f = FLOPS_PER_CELL[name] * float(
                    (numpy.asarray(cells_to(args), numpy.float64) * lengths[p_idx]).sum())
            flops += f
            nbytes += b
        return flops, nbytes

    def tensor_bytes(*tensors):
        return sum(float(t.numel() * t.element_size()) for t in tensors)

    def envelope_bytes(args):
        """Kernel G's inputs: the bfloat16 planes and float32 logs of each
        row's envelope residues only, its envelope and its total."""
        _s, _p, planes, logs, iv, jv, total = args
        residues = float((numpy.asarray(jv) - numpy.asarray(iv) + 1).sum())
        return (residues * (planes.shape[0] * planes.shape[3] * planes.element_size()
                            + logs.shape[0] * logs.element_size())
                + tensor_bytes(total) + 8.0 * len(iv))

    outs, ms, plain_ms = run(stream.posterior_fwd, stream.posterior_fwd_plain, groups, 3)
    report("posterior_fwd",
           [("trajectory", got[0][:4], want[0][:4]) for got, want in outs]
           + [("log_scale", got[0][4], want[0][4]) for got, want in outs]
           + [("log_scale", got[1], want[1]) for got, want in outs], ms, plain_ms,
           work("posterior_fwd", groups, outs))
    fwd = [want for _got, want in outs]
    bwd_args = [(*g, *f) for g, f in zip(groups, fwd)]
    outs, ms, plain_ms = run(stream.posterior_bwd, stream.posterior_bwd_plain, bwd_args, 3)
    report("posterior_bwd", [("trajectory", got, want) for got, want in outs], ms, plain_ms,
           work("posterior_bwd", bwd_args, outs, in_bytes=lambda a: tensor_bytes(*a[2:])))

    # the envelope rows of every pair, from the plain posteriors; a class
    # whose pairs yield no envelope takes each pair's whole sequence
    rows = []
    per_class = []
    for w, (s_idx, p_idx), (_traj, score), (_got, post) in zip(classes, groups, fwd, outs):
        lens = pack.lens[torch.as_tensor(s_idx, device=device)]
        env_i, env_j, _over = stream.envelopes(post[0], post[1], lens)
        env_i, env_j, score = (t.cpu().numpy() for t in (env_i, env_j, score))
        r, slot = numpy.nonzero(env_j >= env_i)
        iv, jv = env_i[r, slot], env_j[r, slot]
        forced = not len(r)
        if forced:
            r = numpy.arange(len(s_idx))
            iv, jv = numpy.ones(len(r), numpy.int32), pack.lens_host[s_idx]
        per_class.append((int(w), len(r), forced))
        rows.append(((s_idx[r], p_idx[r]),
                     (iv, jv, torch.as_tensor(numpy.ascontiguousarray(score[r]), device=device))))
    print(f"# alignment rows per class (width, rows, whole sequences): {per_class}", flush=True)
    require(all(n > 0 for _w, n, _forced in per_class), "a width class has no alignment row")

    bwd_rows = [g for g, _env in rows]
    outs, ms, plain_ms = run(stream.align_bwd, stream.align_bwd_plain, bwd_rows, 2)
    report("align_bwd",
           [("planes", got[0], want[0]) for got, want in outs]
           + [("log_scale", got[1], want[1]) for got, want in outs], ms, plain_ms,
           work("align_bwd", bwd_rows, outs))
    planes = [want for _got, want in outs]
    fwd_rows = [(*g, *pl, *env) for (g, env), pl in zip(rows, planes)]
    outs, ms, plain_ms = run(stream.align_fwd, stream.align_fwd_plain, fwd_rows, 2)
    for got, want in outs:
        require(torch.equal(got[1], want[1]), "align_fwd coordinates differ from plain")
    report("align_fwd",
           [("log_scale", got[0][:, 0], want[0][:, 0]) for got, want in outs]
           + [("logn2", got[0][:, 1:], want[0][:, 1:]) for got, want in outs], ms, plain_ms,
           work("align_fwd", fwd_rows, outs, in_bytes=envelope_bytes, cells_to=lambda a: a[5]))


def profiled_search(pipeline, seqs, device, path):
    """One search with the launch counts set to 0 just before it and read
    just after, under ``torch.profiler`` (device activity only); prints its
    accounting and requires every kernel of ``path`` to have launched and
    every hit to be well formed.  Returns the hits and the launch counts."""
    from gecco_tpu_torch import _build

    _ = pipeline.bank  # upload outside the timed search
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
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
    print(f"# domains: {pipeline.host_pairs} of {pipeline.stage_counts['F3']} candidate pairs "
          f"defined by the host engine; peak device memory "
          f"{torch.cuda.max_memory_allocated(device)} bytes", flush=True)
    for name in path:
        require(launches[name] > 0, f"kernel {name} was not launched by the search")
    require(pipeline.stage_counts.get("reported", 0) > 0, "no hit reported")
    # messages are built only for a failure: a hit's repr prints its
    # profile's arrays, and a search may report ~10^5 hits
    bad = [(h.sequence_index, h.profile.name) for h in hits
           if not (numpy.isfinite(h.score) and h.domains)]
    require(not bad, f"malformed hits {bad[:5]}")
    bad = [(h.sequence_index, h.profile.name, d) for h in hits for d in h.domains
           if not (1 <= d.ienv <= d.target_from <= d.target_to <= d.jenv
                   and 1 <= d.hmm_from <= d.hmm_to <= h.profile.M
                   and numpy.isfinite(d.bitscore))]
    require(not bad, f"malformed domains {bad[:5]}")
    return hits, launches


def compare_with_plain(pipeline, profiles, head, device, **options):
    """The same search of the first proteins on the plain PyTorch versions:
    the same funnel, hits and domain coordinates, scores within 5e-3 bits."""
    from gecco_tpu_torch.hmm.pipeline import SearchPipeline

    plain = SearchPipeline(profiles, device=device, Z=N_PROFILES, domZ=N_PROFILES,
                           backend="torch", **options)
    a, b = pipeline.search(head), plain.search(head)
    require(pipeline.stage_counts == plain.stage_counts,
            f"funnel {pipeline.stage_counts} != plain {plain.stage_counts}")
    require([(h.sequence_index, h.profile.name) for h in a]
            == [(h.sequence_index, h.profile.name) for h in b], "hits differ from plain")
    for x, y in zip(a, b):
        require(abs(x.score - y.score) <= 5e-3, f"score {x.score} != plain {y.score}")
        require([(d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to)
                 for d in x.domains]
                == [(d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to)
                    for d in y.domains], "domain envelopes or coordinates differ from plain")
        for dx, dy in zip(x.domains, y.domains):
            require(abs(dx.bitscore - dy.bitscore) <= 1e-2,
                    f"domain score {dx.bitscore} != plain {dy.bitscore}")
    print(f"# reference (plain torch, {len(head)} proteins): {len(b)} hits agree, "
          f"stage_counts {json.dumps(plain.stage_counts)}", flush=True)


def phase_search(device, state):
    from gecco_tpu_torch.hmm.calibrate import calibrate
    from gecco_tpu_torch.hmm.pipeline import SearchPipeline
    from gecco_tpu_torch.hmm.synthetic import bench_workload
    from gecco_tpu_torch.orf import _native

    t0 = time.perf_counter()
    genome, profiles, seqs = bench_workload(GENOME_GENES, N_PROFILES)
    print(f"# workload: {len(genome)} bp, {len(seqs)} proteins "
          f"({sum(map(len, seqs))} residues) x {len(profiles)} profiles "
          f"in {time.perf_counter() - t0:.3f} s; gene calling on the "
          f"{_native.path()} ORF path", flush=True)
    t0 = time.perf_counter()
    calibrate(profiles, device=device)
    torch.cuda.synchronize()
    print(f"# calibrate (port, kernels): {time.perf_counter() - t0:.3f} s", flush=True)

    pipeline = SearchPipeline(profiles, device=device, Z=N_PROFILES, domZ=N_PROFILES,
                              backend="cuda")
    hits, launches = profiled_search(pipeline, seqs, device, DEFAULT_PATH)
    for stage, count in FUNNEL.items():
        require(pipeline.stage_counts.get(stage) == count,
                f"funnel at {stage}: {pipeline.stage_counts.get(stage)} != {count}")
    compare_with_plain(pipeline, profiles, seqs[:48], device)
    state.update(genome=genome, profiles=profiles, seqs=seqs, launches=launches,
                 hits={(h.sequence_index, h.profile.name) for h in hits})


def phase_max_filter(device, state):
    """hmmsearch ``--max``: every pair Forward-scored by kernel H."""
    from gecco_tpu_torch.hmm.kernels import SeqPack
    from gecco_tpu_torch.hmm.pipeline import SearchPipeline

    profiles, seqs = state["profiles"], state["seqs"]
    pipeline = SearchPipeline(profiles, device=device, Z=N_PROFILES, domZ=N_PROFILES,
                              max_filter=True, backend="cuda")
    hits, launches = profiled_search(pipeline, seqs, device, MAX_FILTER_PATH)
    pairs = FUNNEL["pairs"]
    require(pipeline.stage_counts["F1"] == pipeline.stage_counts["F2"] == pairs,
            f"max_filter funnel {pipeline.stage_counts} does not pass all {pairs} pairs")
    require(pipeline.stage_cells["filter"] == 0.0, "max_filter charged filter cells")
    for name in ("ssv_filter", "viterbi_pairs", "forward_pairs"):
        require(launches[name] == 0, f"max_filter launched the filter kernel {name}")
    got = {(h.sequence_index, h.profile.name) for h in hits}
    require(state["hits"] <= got, f"{len(state['hits'] - got)} default hits missing "
                                  "from the max_filter search")
    print(f"# max_filter: {pipeline.stage_counts['F3']} candidate pairs reached domain "
          f"definition; {len(got)} hits, {len(got - state['hits'])} beyond the default "
          f"search's {len(state['hits'])}", flush=True)
    work = all_pairs_work(SeqPack(seqs, device), pipeline.bank.lengths.cpu().numpy(),
                          FLOPS_PER_CELL["dense_forward"])
    print(f"# kernel dense_scores on the search: {json.dumps(bound(*work))} "
          f"({work[0]!r} flops, {work[1]!r} bytes)", flush=True)
    compare_with_plain(pipeline, profiles, seqs[:48], device, max_filter=True)
    state.update(max_launches=launches)


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

    def report(name, checks, ms, plain_ms, work, **extra):
        """Hold a kernel's outputs against its plain version's: ``checks`` are
        ``(tolerance key, got, want)``.  ``max_abs_err`` covers the outputs
        held to an absolute tolerance; the bfloat16 planes are held to
        ``|got - want| <= 1e-30 + PLANE_RTOL |want|`` and give ``max_rel_err``.
        ``work`` is the ``(flops, bytes)`` of the timed launches, whose bound
        goes beside ``ms``; no single PyTorch call computes these
        recurrences, so ``library_ms`` is null."""
        entry = {"max_abs_err": 0.0}
        for key, got, want in checks:
            got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
            require(got.shape == want.shape and numpy.isfinite(got).all(), f"{name}: bad output")
            if not got.size:
                continue
            diff = numpy.abs(got - want)
            if key == "planes":
                require(bool((diff <= 1e-30 + PLANE_RTOL * numpy.abs(want)).all()),
                        f"{name} planes differ from plain by more than one bfloat16 step")
                rel = float((diff / numpy.maximum(numpy.abs(want), 1e-30)).max())
                entry["max_rel_err"] = max(entry.get("max_rel_err", 0.0), rel)
                continue
            e = float(diff.max())
            require(e <= TOL[key], f"{name} disagrees with its plain version: {key} {e}")
            entry["max_abs_err"] = max(entry["max_abs_err"], e)
        tols = sorted({TOL[key] for key, *_rest in checks if key in TOL})
        entry.update(ms=ms, plain_ms=plain_ms, **bound(*work), library_ms=None, **extra)
        print(f"# kernel {name}: {json.dumps(entry)} (abs tol {tols}"
              + (f", planes rel tol {PLANE_RTOL}" if "max_rel_err" in entry else "")
              + f"; {work[0]!r} flops, {work[1]!r} bytes)", flush=True)
        kernels[name] = entry

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
    with Phase("4 max-filter search"):
        phase_max_filter(device, state)
    with Phase("5 cli"):
        phase_cli(device, state)

    loaded = sorted(name for name, module in sys.modules.items()
                    if module is not None and name.split(".")[0] in ("jax", "gecco_tpu"))
    require(not loaded, f"JAX or the JAX package was imported: {loaded}")
    # each kernel's launches on the search whose path it is
    launches = {**state["launches"], "dense_scores": state["max_launches"]["dense_scores"]}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": REPLACES[name][0],
         "replaces": REPLACES[name][1], "launches": launches[name], **kernels[name]}
        for name in REPLACES
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
