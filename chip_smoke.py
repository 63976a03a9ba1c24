#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port end to end on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (each prints its wall seconds, each ends in a device sync):

1. device: require CUDA, print the card's name and power limit, build
   the kernels from ``gecco_tpu_torch/csrc`` (printing the build's
   seconds), print the registers and spills (``nvcc -Xptxas -v``) of
   every instantiation of kernels A-K (H in both semirings);
2. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the main path's shapes (2,766 Pfam-shaped profiles plus one
   of 2,100 nodes), with a stated tolerance, timed beside it (A, C, H
   and I also per width class, each class launched alone between CUDA
   events, C, H and I with each class's cells and rates; B per width
   class from the profiler); the
   domain kernels D-G over 256 proteins with planted domains against
   their planted profiles (the bank's width classes in turn) and against
   the wide profile, one launch per width class as the search makes
   them, and over the envelope rows those pairs yield (every class has
   rows); D-G again on rows of up to 6,000 residues against profiles of
   the 1,024-, 2,048- and 4,096-node classes, one launch a class (G over
   whole sequences), their launches counted over those calls alone; the pair kernels J and K over the same pairs and rows, beside
   D + E and F + G, and kernels B and C over each row's envelope as a
   residue window (``ranges``; a window of the whole sequence equal to
   the launch without one); the dense kernel H in both semirings over 32 proteins against
   the whole bank (every width class, 128 to 4,096 nodes), and against
   kernels C and B on the same pairs; the MSV kernel I on the first
   bank (every MSV score at least the SSV score of its pair); kernel A on
   two small banks of the widths the TPU's other SSV variants served,
   profiles that fill their width class (128 and 256 nodes) and
   profiles within three nodes of it (125-127), each protein with a
   consensus ending on the last node;
3. search: ``SearchPipeline(backend="cuda").search`` at the benchmark
   shape (a 3,230-gene synthetic genome, ~3,000 called proteins cut to
   512 residues with planted domains, 2,766 profiles calibrated by the
   port's own ``calibrate``), launch counts of every kernel, the
   survivor funnel, the pairs whose domains the host engine defined,
   peak device memory, the device ms of kernels A-G per width class
   (A-C launched once a class, D-G once a class and launch group),
   ``calibrate``'s wall and launches (kernel A once a width class, kernel
   H once a class in each semiring, no B or C), kernel C alone on the
   search's F3 pairs and kernel H alone on ``calibrate``'s 256
   background sequences in both semirings, per width class between CUDA
   events, kernels D-G alone over the rows the search gave
   them (E on D's outputs, G on F's planes and the search's envelopes),
   per width class between CUDA events, and the same search on plain
   PyTorch for the first proteins as a reference;
4. max-filter search: ``SearchPipeline(max_filter=True,
   backend="cuda").search`` (hmmsearch ``--max``) over the same
   workload, every pair Forward-scored by kernel H (one launch a width
   class): its funnel, launch counts, the candidates that reach domain
   definition (210,321, and 186,503 reported, as recorded), H's
   device ms, cells and rates per width class, D-G's device ms per
   width class, peak device memory, its hits against the default
   search's (a superset) and against the same search on plain PyTorch
   for the first proteins; then H alone over the whole pack in both
   semirings, per width class between CUDA events, with rows of its
   first, middle and last tiles (the ragged last tile whole) held
   against the plain version, and D-G alone over the search's rows per
   width class between CUDA events;
5. MSV search: ``SearchPipeline(filter_stage="msv", backend="cuda")``
   (HMMER 3.0's multi-segment filter, kernel I, in place of kernel A)
   over the same workload: its funnel (F1 at least the default's, since
   no MSV score is below its SSV score), launch counts, peak device
   memory, the same search on plain PyTorch for the first proteins, and
   that comparison again with ``bias_filter=False`` (hmmsearch
   ``--nobias``); then I alone over the whole pack, per width class
   between CUDA events, with rows of its first, middle and last tiles
   (the ragged last tile whole) held against the plain version bit for
   bit;
6. pair domains: ``PairDomains(backend="cuda").define`` (kernels J and
   K) over the F3 candidates of phase 3, the same domains as
   ``StreamDomains.define`` gives on them, its launch counts, device
   milliseconds, peak device memory and host pairs; the same against
   plain PyTorch on the first proteins' candidates; the device ms of J,
   K and D-G per width class (profiler), then J and K alone over the rows
   ``PairDomains.define`` gave them and D-G alone over the rows
   ``StreamDomains.define`` gave them (each launch prepared, then timed
   between CUDA events), with each class's rows and J's and K's bound per
   class; the bounds of kernels D-G, J and K on that work; and every
   envelope found rescored as a residue window by kernels C and B against
   their plain versions, timed per width class between CUDA events;
7. CLI: ``gecco-tpu-torch run`` on the genome with the calibrated bank
   written as ``.h3m`` (accessions renamed to the embedded model's
   Pfam whitelist);
8. train: ``ClusterCRF.fit`` on the card at the shipped model's width and
   settings (``gecco_tpu_torch/data/crf_model.npz``: protein features,
   windows of 20, c1 = 0.4, c2 = 0, L-BFGS/OWL-QN, 2,659 of its 11,064
   candidate features selected) over a synthetic corpus of 240 contigs x
   500 genes named from those candidates with planted cluster runs: its
   windows, vocabulary, host seconds (selection, instances, index), fit
   seconds, evaluations, device ms per evaluation (CUDA events, and the
   profiler's busy ms), peak device memory, objective and non-zero
   weights, and 24 held-out contigs predicted on the card (8a); the same
   strictly convex fit (c1 = 0, c2 = 0.05) of a cut corpus on the card and
   on the CPU: the objective and gradient at the same points, Adam's fits
   within stated bounds, L-BFGS's gaps beside those of a second window
   order on the card (8b); ``annotate``,
   ``predict`` (giving phase 7's clusters table), ``train``, ``predict
   --model``, ``cv`` and ``convert`` on the card, from phase 7's genome
   and output (8c);
9. the modules around the kernels, each sub-phase with its wall seconds
   and device ms: ``tools/torch_check.py`` in-process (9a); the float64
   host path (``use_accelerator=False``) against the kernels on 16 of
   phase 3's proteins and 64 of its profiles: no launch, no device
   memory, every kernel hit a host hit but for float64 gate values
   within 1e-3 of their thresholds, scores within 5e-3 bits, seconds a
   pair (9b); phase 3's search sharded over two slots of the one card
   (``devices=[cuda:0, cuda:0]``, a thread each): phase 3's funnel and
   hits, the launches of the two shards alone, ``stage_devices`` 2; and
   pinned to ``[cuda:0]`` (9c); ``sharded_forward_scores`` on a 2 x 2
   mesh of the card over phase 4's bank and 32 proteins in both
   semirings against one ``dense_scores`` call (9d); ``crf_train_step``
   on a 2-slot data mesh of the card over 8a's windows against the
   1-slot step (9e); ``run --profile DIR`` (a trace naming kernel A's
   ``ssv_kernel``, phase 7's clusters table) and ``run --devices 1``
   (phase 7's tables) (9f).

The searches of phases 3, 4 and 5 and the domain definition of phase 6
run under ``torch.profiler`` (device activity only), which gives each
kernel's device milliseconds and the card's idle share; the launch
counts are set to 0 just before each and read just after it.  The line before the last
is a JSON object describing each kernel (its launches on the search
that runs it, its error against the plain version, its time, the plain
version's time and its bound); the last line is ``{"ok": true,
"device": {...}}``.  Any failure exits non-zero before that line.  JAX
and the JAX package are blocked from import: the port and this script
must run without them.
"""

import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None  # any import of JAX fails
sys.modules["gecco_tpu"] = None  # and of the JAX package

import numpy
import torch

from gecco_tpu_torch.profiling import TIMER

N_PROFILES = 2766
GENOME_GENES = 3230
WIDE_NODES = 2100
DOMAIN_PROTEINS = 256
#: proteins of the dense kernel's check against its plain version
DENSE_PROTEINS = 32
#: the survivor funnel of the search through F3 (``stage_counts``), measured
#: on the H100 with the stats ``calibrate`` fits from kernels A and H; its
#: earlier scoring on kernels A, B and C gave the same funnels (the Viterbi
#: locations moved by at most 9.1e-5 bits, the others not at all)
FUNNEL = {"pairs": 8339490, "F1": 417790, "F2": 31893, "F3": 1800}
#: the ``max_filter`` search's candidates and reported hits (measured on
#: the H100 since kernel H was first ported)
MAX_FILTER_FUNNEL = {"F3": 210321, "reported": 186503}
#: the same with ``filter_stage="msv"`` (measured on the H100)
MSV_FUNNEL = {"pairs": 8339490, "F1": 417859, "F2": 31908, "F3": 1813}
#: proteins of the searches held against the plain PyTorch search
HEAD = 48
#: proteins and profiles (``13 i mod 2,766``, those planted in the first
#: proteins and others) of phase 9b's float64 host path
HOST_PROTEINS, HOST_PROFILES = 16, 64
#: the long rows of kernels D-G: model lengths of the 1,024-, 2,048- and
#: 4,096-node classes, and sequence lengths past JAX's 4,096-residue pack
#: limit (and one short row, zeros past it to the stride)
LONG_MODELS, LONG_SEQS = (1000, 2000, 2200), (6000, 5900, 300)
#: learning rate of phase 9e's step over 8a's ~115,000 windows (a summed loss)
TRAIN_STEP_LR = 1e-5
#: absolute tolerances (nats, or probabilities): max-plus kernels are
#: exact up to their order of maxima; sum-product kernels and their log
#: scales sum in another order than the plain versions; trajectories,
#: posteriors and null2 log-ratios likewise
TOL = {"ssv_filter": 1e-4, "msv_filter": 1e-4, "viterbi_pairs": 1e-4, "forward_pairs": 1e-3,
       "viterbi_window": 1e-4, "forward_window": 1e-3,
       "trajectory": 1e-4, "log_scale": 1e-3, "logn2": 1e-3,
       "dense_forward": 1e-3, "dense_viterbi": 1e-4}
#: kernel H against kernels C and B (the same functions by other
#: recurrences: per-pair blocks, and B in log space)
CROSS_TOL = 5e-3
#: how far an MSV score may fall below its SSV score: none in exact
#: arithmetic, but MSV adds the length model's loop to C once a residue
#: (up to 512 float32 additions) where SSV takes L * loop as one product
#: (1.85e-4 nats measured on the H100, over 1e-4)
MSV_SSV_TOL = 1e-3
#: relative tolerance of the bfloat16 planes: one bfloat16 step (2^-7 of
#: the value at the bottom of a binade), where float32 values that differ
#: in their last bits round apart
PLANE_RTOL = 2.0 ** -7
#: source of each kernel and the TPU kernels it replaces; kernel A computes
#: the function of all three SSV variants (4, 1 and 2 residues a roll)
REPLACES = {
    "ssv_filter": ("gecco_tpu_torch/csrc/ssv.cu",
                   "gecco_tpu/hmm/kernels.py:643, gecco_tpu/hmm/kernels.py:467, "
                   "gecco_tpu/hmm/kernels.py:544"),
    "viterbi_pairs": ("gecco_tpu_torch/csrc/viterbi.cu",
                      "gecco_tpu/hmm/kernels.py:1312, gecco_tpu/hmm/kernels.py:1181"),
    "forward_pairs": ("gecco_tpu_torch/csrc/forward.cu",
                      "gecco_tpu/hmm/stream.py:1047, gecco_tpu/hmm/kernels.py:1181"),
    "posterior_fwd": ("gecco_tpu_torch/csrc/stream_fwd.cu", "gecco_tpu/hmm/stream.py:60"),
    "posterior_bwd": ("gecco_tpu_torch/csrc/stream_bwd.cu", "gecco_tpu/hmm/stream.py:216"),
    "align_bwd": ("gecco_tpu_torch/csrc/align_bwd.cu", "gecco_tpu/hmm/stream.py:395"),
    "align_fwd": ("gecco_tpu_torch/csrc/align_fwd.cu", "gecco_tpu/hmm/stream.py:568"),
    "dense_scores": ("gecco_tpu_torch/csrc/dense.cu", "gecco_tpu/hmm/kernels.py:1051"),
    "msv_filter": ("gecco_tpu_torch/csrc/msv.cu", "gecco_tpu/hmm/kernels.py:273"),
    "pair_posterior": ("gecco_tpu_torch/csrc/pair_posterior.cu",
                       "gecco_tpu/hmm/kernels.py:1718"),
    "pair_align": ("gecco_tpu_torch/csrc/pair_align.cu", "gecco_tpu/hmm/kernels.py:2072"),
}
#: name of each wrapper's ``__global__`` function (templates add ``<W>``)
GLOBALS = {"ssv_filter": "ssv_kernel", "viterbi_pairs": "viterbi_kernel",
           "forward_pairs": "forward_kernel", "posterior_fwd": "posterior_fwd_kernel",
           "posterior_bwd": "posterior_bwd_kernel", "align_bwd": "align_bwd_kernel",
           "align_fwd": "align_fwd_kernel", "dense_scores": "dense_kernel",
           "msv_filter": "msv_kernel", "pair_posterior": "pair_posterior_kernel",
           "pair_align": "pair_align_kernel"}
#: the kernels of each search: the default path (phase 3), max_filter
#: (phase 4) and the MSV filter stage (phase 5)
DOMAIN_PATH = ("posterior_fwd", "posterior_bwd", "align_bwd", "align_fwd")
DEFAULT_PATH = ("ssv_filter", "viterbi_pairs", "forward_pairs", *DOMAIN_PATH)
MAX_FILTER_PATH = ("dense_scores", *DOMAIN_PATH)
MSV_PATH = ("msv_filter", "viterbi_pairs", "forward_pairs", *DOMAIN_PATH)
#: the kernels of ``PairDomains.define`` (phase 6)
PAIR_PATH = ("pair_posterior", "pair_align")
#: the least time of a kernel's work (``bound_ms``): the larger of its float
#: operations over the H100 SXM's float32 peak outside the tensor cores and
#: its bytes (each input read once, each output written once) over the HBM
#: rate (NVIDIA's data sheet, at the 700 W limit)
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: float operations per DP cell (one residue against one node) of each
#: recurrence: A = emission minus loop, entry max, add, running max; I =
#: emission add, entry max, running max of E (its per-row scalars are O(L)); B = the
#: max-plus M/I/D updates (11) and the prefix-max delete chain (3) and E (1);
#: C, D and H's Forward = the sum-product updates (11), delete chain (3),
#: E sum (2), rescale (3), H's Viterbi one fewer (E a max of M alone); E and
#: F = the Backward step with its delete chain and rescale; G = the Forward
#: and the envelope Forward (2 x 19), posteriors (6) and the optimal-accuracy
#: DP (20); J = D's and E's steps over every cell; K = F's step over the
#: cells from the envelope's first residue to the last of the sequence and
#: G's over those up to the envelope's last
FLOPS_PER_CELL = {"ssv_filter": 4, "msv_filter": 3, "viterbi_pairs": 15, "forward_pairs": 19,
                  "posterior_fwd": 19, "posterior_bwd": 24, "align_bwd": 24,
                  "align_fwd": 64, "dense_forward": 19, "dense_viterbi": 18,
                  "pair_posterior": 19 + 24}
#: float32 planes a Forward/Backward kernel reads per node of a profile
#: (21 emission rows and 8 transitions)
PLANES = 29
#: seconds between opening a measured profiler trace and the work it
#: measures (:func:`device_trace`)
TRACE_LEAD_S = 1.0
#: phase 8's training corpus: contigs of genes (about 40 genomes of the
#: bench genome's size), contigs held out for prediction, names of the
#: planted runs' domains, and the cut corpus of the card-against-CPU fits
TRAIN_CONTIGS, TRAIN_GENES, HELD_OUT = 240, 500, 24
CLUSTER_POOL = 500
CUT_CONTIGS, CUT_GENES = 24, 200
TRAIN_SEED = 12
#: evaluations of the objective and gradient traced by the profiler
EVALUATIONS_TRACED = 5
#: two float32 fits of one strictly convex objective (c1 = 0, c2 = 0.05),
#: on the card and on the CPU, whose sums run in other orders: flat
#: directions stop where the float32 objective stops resolving
#: (``tests/test_train.py`` bounds two optimizers on one optimum by 0.25 in
#: the weights).  Required of Adam's 300 steps; the copied L-BFGS stops
#: short of the optimum on the cut corpus, at a point that the order of
#: the sums alone moves by more, so its gaps are printed
FIT_OBJECTIVE_RTOL, FIT_WEIGHT_ATOL, FIT_PROBABILITY_ATOL = 1e-4, 0.25, 2e-2
#: the objective and its gradient on the card against the CPU at one point
#: (``tests/test_torch_train.py`` holds ``nll`` to a float64 forward
#: algorithm at 1e-5 relative, and its gradient at 1e-4 of its largest
#: magnitude)
EVALUATION_RTOL = 1e-4


def require(condition, message):
    """Fail the run (``assert`` would vanish under ``python -O``)."""
    if not condition:
        raise RuntimeError(message)


def launch_counts():
    """Each kernel's launches since the timer's last reset (its counters
    ``launch.<kernel>``); 0 for a kernel not launched."""
    return collections.Counter({key[len("launch."):]: n for key, n in TIMER.counters.items()
                                if key.startswith("launch.")})


def stage_span_seconds():
    """The seconds of each search stage span since the timer's last reset
    (one a shard), by name."""
    out = {}
    for span in TIMER.export()["spans"]:
        if span["name"] in ("filter", "viterbi", "forward", "domains"):
            out.setdefault(span["name"], []).append((span["end_ns"] - span["start_ns"]) / 1e9)
    return out


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


@contextlib.contextmanager
def device_trace():
    """A device-only ``torch.profiler`` trace for measured work.  The first
    launches of a trace were seen to go unrecorded (kernel A's five of a
    search; kernel H's first one or two width classes in phase 2, after a
    throwaway trace), so the trace opens right after a throwaway one and
    its body starts ``TRACE_LEAD_S`` seconds after it opens."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1024, device="cuda").sum()
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_LEAD_S)
        yield prof


def device_ms(prof):
    """Device milliseconds of each kernel name in a ``torch.profiler`` run."""
    out = {}
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = event.self_cuda_time_total
        if us:
            out[event.key] = us / 1e3
    return out


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


#: width class (nodes) of a templated ``__global__`` function's arguments:
#: lanes x nodes a lane, or threads x nodes a thread
#: (kernel H's last template argument is its semiring, 1 for Viterbi)
WIDTH_OF = {"ssv_kernel": lambda c: 32 * c, "ssv_kernel_wide": lambda c: 32 * c,
            "viterbi_kernel": lambda c: 32 * c,
            "viterbi_kernel_wide": lambda t, c: t * c, "msv_kernel": lambda c: 32 * c,
            "msv_kernel_wide": lambda c: 32 * c, "forward_kernel": lambda c: 32 * c,
            "forward_kernel_wide": lambda t, c: t * c,
            "pair_align_kernel": lambda c: 32 * c,
            "pair_align_kernel_wide": lambda t, c: t * c,
            "pair_posterior_kernel": lambda c: 32 * c,
            "pair_posterior_kernel_wide": lambda t, c: t * c,
            "posterior_fwd_kernel": lambda c: 32 * c,
            "posterior_fwd_kernel_wide": lambda t, c: t * c,
            "posterior_bwd_kernel": lambda c: 32 * c,
            "posterior_bwd_kernel_wide": lambda t, c: t * c,
            "align_bwd_kernel": lambda c: 32 * c, "align_bwd_kernel_wide": lambda t, c: t * c,
            "align_fwd_kernel": lambda c: 32 * c, "align_fwd_kernel_wide": lambda t, c: t * c,
            "dense_kernel": lambda c, v: 32 * c, "dense_kernel_wide": lambda t, c, v: t * c}
#: phase 1's ``-Xptxas -v`` reports: source, ``__global__`` name, instantiations
REGISTER_REPORTS = (("ssv.cu", "ssv_kernel", 5), ("ssv.cu", "ssv_kernel_wide", 1),
                    ("viterbi.cu", "viterbi_kernel", 4),
                    ("viterbi.cu", "viterbi_kernel_wide", 2),
                    ("msv.cu", "msv_kernel", 5), ("msv.cu", "msv_kernel_wide", 1),
                    ("forward.cu", "forward_kernel", 4), ("forward.cu", "forward_kernel_wide", 2),
                    ("stream_fwd.cu", "posterior_fwd_kernel", 4),
                    ("stream_fwd.cu", "posterior_fwd_kernel_wide", 2),
                    ("stream_bwd.cu", "posterior_bwd_kernel", 4),
                    ("stream_bwd.cu", "posterior_bwd_kernel_wide", 2),
                    ("align_bwd.cu", "align_bwd_kernel", 4),
                    ("align_bwd.cu", "align_bwd_kernel_wide", 2),
                    ("align_fwd.cu", "align_fwd_kernel", 2),
                    ("align_fwd.cu", "align_fwd_kernel_wide", 4),
                    ("pair_posterior.cu", "pair_posterior_kernel", 4),
                    ("pair_posterior.cu", "pair_posterior_kernel_wide", 2),
                    ("pair_align.cu", "pair_align_kernel", 2),
                    ("pair_align.cu", "pair_align_kernel_wide", 4),
                    ("dense.cu", "dense_kernel", 8), ("dense.cu", "dense_kernel_wide", 4))
#: the ``__global__`` functions of each kernel timed by width class
CLASS_KERNELS = {"ssv_filter": ("ssv_kernel", "ssv_kernel_wide"),
                 "viterbi_pairs": ("viterbi_kernel", "viterbi_kernel_wide"),
                 "msv_filter": ("msv_kernel", "msv_kernel_wide"),
                 "forward_pairs": ("forward_kernel", "forward_kernel_wide"),
                 "dense_scores": ("dense_kernel", "dense_kernel_wide"),
                 "posterior_fwd": ("posterior_fwd_kernel", "posterior_fwd_kernel_wide"),
                 "posterior_bwd": ("posterior_bwd_kernel", "posterior_bwd_kernel_wide"),
                 "align_bwd": ("align_bwd_kernel", "align_bwd_kernel_wide"),
                 "align_fwd": ("align_fwd_kernel", "align_fwd_kernel_wide"),
                 "pair_posterior": ("pair_posterior_kernel", "pair_posterior_kernel_wide"),
                 "pair_align": ("pair_align_kernel", "pair_align_kernel_wide")}


def ptxas_usage(text, name):
    """``{template arguments: usage}`` of kernel ``name`` in ``nvcc -Xptxas -v``
    output: registers, stack frame and spill bytes of each instantiation."""
    found = {}
    for mangled, stack, stores, loads, regs in re.findall(
            r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, (\d+) bytes spill "
            r"stores, (\d+) bytes spill loads\n[^\n]*?Used (\d+) registers", text):
        match = re.search(rf"{len(name)}{name}I((?:Li\d+E)+)E", mangled)
        if match:
            args = tuple(int(a) for a in re.findall(r"Li(\d+)E", match.group(1)))
            found[args] = {"registers": int(regs), "stack": int(stack),
                           "spill_stores": int(stores), "spill_loads": int(loads)}
    return found


def phase_registers():
    """``-Xptxas -v`` registers and spills of every instantiation of kernels
    A-K, one ``nvcc`` a source, side by side."""
    from concurrent.futures import ThreadPoolExecutor

    from gecco_tpu_torch import _build

    sources = sorted({source for source, _name, _count in REGISTER_REPORTS})
    with ThreadPoolExecutor(len(sources)) as pool:
        text = dict(zip(sources, pool.map(_build.resource_usage, sources)))
    for source, name, count in REGISTER_REPORTS:
        usage = ptxas_usage(text[source], name)
        require(len(usage) == count,
                f"nvcc -Xptxas -v reported {len(usage)} instantiations of {name}, not {count}")
        width = WIDTH_OF[name]
        print(f"# kernel {name} (-Xptxas -v) " + json.dumps(
            {f"{width(*args)} nodes ({'x'.join(map(str, args))})": u
             for args, u in sorted(usage.items(), key=lambda kv: width(*kv[0]))}), flush=True)


def class_ms(by_key, label):
    """Device ms of kernel ``label`` (a wrapper with a ``CLASS_KERNELS``
    entry) per width class, from :func:`device_ms` of a profiler run."""
    per_class = {}
    for name in CLASS_KERNELS[label]:
        for key, ms in by_key.items():
            match = re.search(rf"\b{name}<([\d, ]+)>", key)
            if match:
                width = WIDTH_OF[name](*(int(a) for a in match.group(1).split(",")))
                per_class[width] = per_class.get(width, 0.0) + ms
    return dict(sorted(per_class.items()))


def print_class_ms(label, fn):
    """Run ``fn()`` once under :func:`device_trace`; print kernel ``label``'s
    device ms per width class."""
    with device_trace() as prof:
        fn()
        torch.cuda.synchronize()
    print(f"# kernel {label} per width class (profiler, device ms): "
          f"{json.dumps(class_ms(device_ms(prof), label))}", flush=True)


def class_events_ms(fn, bank, repeats):
    """Device ms per width class of ``fn(bank)``, a wrapper that launches
    once a width class of ``bank``: each class alone (a bank of that class
    only) between CUDA events, the mean of ``repeats`` after a warm-up."""
    return {width: timed_ms(lambda: fn(dataclasses.replace(bank, classes=[(width, idx)])),
                            repeats)[1]
            for width, idx in bank.classes}


def print_rates(label, per_class, cells, computed):
    """A kernel's device ms per width class beside the class's DP cells:
    real (model lengths) and computed (the nodes a row the kernel runs),
    and the rates they give."""
    rates = {}
    for width in cells:
        ms = per_class.get(width)
        rates[width] = {"ms": ms, "cells": cells[width], "computed_cells": computed[width],
                        "Gcells_per_s": cells[width] / ms / 1e6 if ms else None,
                        "computed_Gcells_per_s": computed[width] / ms / 1e6 if ms else None}
    print(f"# kernel {label} rates per width class: {json.dumps(rates)}", flush=True)


def print_class_rates(label, per_class, pack, bank, nodes):
    """:func:`print_rates` of an all-pairs launch (kernels H and I), a row
    of profile ``p`` computing ``nodes[p]`` nodes."""
    residues = float(pack.lens_host.sum())
    lengths = bank.host.lengths.astype(numpy.float64)
    cells, computed = {}, {}
    for width, idx in bank.classes:
        idx = idx.cpu().numpy()
        cells[width] = residues * float(lengths[idx].sum())
        computed[width] = residues * float(numpy.asarray(nodes, numpy.float64)[idx].sum())
    print_rates(label, per_class, cells, computed)


def pair_class_rates(label, launches_of, pack, bank, s_idx, p_idx, nodes, repeats,
                     ranges=None):
    """Device ms of a pair kernel per width class over pairs ``(s_idx[r],
    p_idx[r])`` (over residue windows ``ranges`` where given): each class's
    launch, prepared beforehand (``launches_of``, e.g.
    ``hmm.stream.forward_launches``), timed alone between CUDA events (mean
    of ``repeats`` after a warm-up), printed with :func:`print_rates`.
    Returns the per-class ms."""
    s_idx, p_idx = numpy.asarray(s_idx), numpy.asarray(p_idx)
    launches, finish = launches_of(pack, bank, s_idx, p_idx, ranges=ranges)
    width = bank.class_of[p_idx]
    residues = (pack.lens_host[s_idx] if ranges is None
                else numpy.diff(numpy.asarray(ranges), axis=1)[:, 0]).astype(numpy.float64)
    lengths = bank.host.lengths.astype(numpy.float64)
    nodes = numpy.asarray(nodes, numpy.float64)
    per_class, cells, computed = {}, {}, {}
    for w, launch in sorted(launches.items()):
        sel = width == w
        per_class[w] = timed_ms(launch, repeats)[1]
        cells[w] = float((residues[sel] * lengths[p_idx[sel]]).sum())
        computed[w] = float((residues[sel] * nodes[p_idx[sel]]).sum())
    finish()
    print_rates(label, per_class, cells, computed)
    return per_class


def phase_kernels(device, report, kernels):
    import warnings

    from gecco_tpu_torch.hmm.bank import TorchBank
    from gecco_tpu_torch.hmm.kernels import (
        SeqPack, dense_nodes, msv_filter, msv_filter_plain, msv_nodes, ssv_filter,
        ssv_filter_plain, viterbi_pairs, viterbi_pairs_plain)
    from gecco_tpu_torch.hmm.stream import forward_launches, forward_pairs, forward_pairs_plain
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

    ssv, ms = timed_ms(lambda: ssv_filter(pack, bank), 5)
    want, plain_ms = timed_ms(lambda: ssv_filter_plain(pack, bank), 1)
    report("ssv_filter", [("ssv_filter", ssv, want)], ms, plain_ms,
           all_pairs_work(pack, lengths, FLOPS_PER_CELL["ssv_filter"], planes=21))
    phase_ssv_widths(device, report)

    got, ms = timed_ms(lambda: msv_filter(pack, bank), 5)
    want, plain_ms = timed_ms(lambda: msv_filter_plain(pack, bank), 1)
    report("msv_filter", [("msv_filter", got, want)], ms, plain_ms,
           all_pairs_work(pack, lengths, FLOPS_PER_CELL["msv_filter"], planes=21))
    below = float((ssv - got).max())
    print(f"# kernel msv_filter: largest SSV score above its MSV score {below!r} nats "
          f"(tol {MSV_SSV_TOL})", flush=True)
    require(below <= MSV_SSV_TOL, f"an MSV score is below its SSV score by {below}")
    per_class = class_events_ms(lambda b: ssv_filter(pack, b), bank, 3)
    print(f"# kernel ssv_filter per width class (CUDA events, ms): {json.dumps(per_class)}",
          flush=True)
    per_class = class_events_ms(lambda b: msv_filter(pack, b), bank, 3)
    print_class_rates("msv_filter (CUDA events)", per_class, pack, bank, msv_nodes(bank))

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
    print_class_ms("viterbi_pairs", lambda: viterbi_pairs(pack, bank, s_idx, p_idx))
    pair_class_rates("forward_pairs (CUDA events)", forward_launches, pack, bank, s_idx, p_idx,
                     dense_nodes(bank), 3)
    phase_dense_kernel(device, bank, seqs[:DENSE_PROTEINS], report)
    phase_domain_kernels(device, profiles, bank, report, kernels)
    phase_long_domain_rows(device, report)


def phase_ssv_widths(device, report):
    """Kernel A on the widths the TPU's other SSV variants served: profiles
    that fill their width class (``_pallas_ssv``'s lane-0 mask) and profiles
    within three nodes of it (``_pallas_ssv_pair``), five proteins each
    with the profile's consensus ending on its last node."""
    from gecco_tpu_torch.hmm.bank import TorchBank
    from gecco_tpu_torch.hmm.kernels import SeqPack, ssv_filter, ssv_filter_plain
    from gecco_tpu_torch.hmm.synthetic import consensus_proteins, synthetic_profiles

    for variant, node_counts in (("full_width", (128, 256)), ("near_cap", (125, 126, 127))):
        profiles = [gm for seed, m in enumerate(node_counts)
                    for gm in synthetic_profiles(1, min_length=m, max_length=m, seed=seed)]
        seqs = [x for seed, gm in enumerate(profiles)
                for x in consensus_proteins(gm, count=5, length=gm.M + 40, seed=seed)]
        pack, bank = SeqPack(seqs, device), TorchBank.build(profiles, device)
        got, ms = timed_ms(lambda: ssv_filter(pack, bank), 5)
        want, plain_ms = timed_ms(lambda: ssv_filter_plain(pack, bank), 1)
        report("ssv_filter", [("ssv_filter", got, want)], ms, plain_ms,
               all_pairs_work(pack, bank.lengths.cpu().numpy(), FLOPS_PER_CELL["ssv_filter"],
                              planes=21), variant=variant)


def phase_dense_kernel(device, bank, seqs, report):
    """Kernel H in both semirings against its plain version, every width
    class of the bank, and against kernels C and B on the same pairs."""
    from gecco_tpu_torch.hmm.kernels import (
        SeqPack, dense_nodes, dense_scores, dense_scores_plain, viterbi_pairs)
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
        per_class = class_events_ms(lambda b: dense_scores(pack, b, viterbi=viterbi), bank, 3)
        print_class_rates(f"dense_scores ({semiring}, CUDA events)", per_class, pack, bank,
                          dense_nodes(bank))
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


def phase_domain_kernels(device, profiles, bank, report, kernels):
    """Kernels D-G, then J and K, against their plain versions, one launch
    per width class; kernels B and C over the envelopes as residue windows."""
    from gecco_tpu_torch.hmm import domains, stream
    from gecco_tpu_torch.hmm.kernels import SeqPack, viterbi_pairs, viterbi_pairs_plain
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

    def max_err(outs):
        """Kernel G's or K's largest errors per width class: ``[envelope
        score, null2 log-ratio]``."""
        return {int(w): [float((got[0][:, c] - want[0][:, c]).abs().max()) for c in
                         (slice(0, 1), slice(1, None))]
                for w, (got, want) in zip(classes, outs)}

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
    null2_err = {"align_fwd": max_err(outs)}

    # kernel J over the pairs of D and E, kernel K over the rows of F and G
    outs, ms, plain_ms = run(domains.pair_posterior, domains.pair_posterior_plain, groups, 3)
    report("pair_posterior",
           [("log_scale", got[0], want[0]) for got, want in outs]
           + [("trajectory", torch.stack(got[1:]), torch.stack(want[1:])) for got, want in outs],
           ms, plain_ms, work("pair_posterior", groups, outs),
           two_kernel_ms=kernels["posterior_fwd"]["ms"] + kernels["posterior_bwd"]["ms"])
    align_rows = [(*g, *env) for g, env in rows]
    outs, ms, plain_ms = run(domains.pair_align, domains.pair_align_plain, align_rows, 2)
    for got, want in outs:
        require(torch.equal(got[1], want[1]), "pair_align coordinates differ from plain")
    flops = nbytes = 0.0
    for (s_idx, p_idx, iv, jv, total), (got, _want) in zip(align_rows, outs):
        iv, jv = numpy.asarray(iv, numpy.float64), numpy.asarray(jv, numpy.float64)
        _f, b = pair_work(pack, lengths, s_idx, p_idx, 0,
                          tensor_bytes(*got, total) + 8.0 * len(iv))
        flops += float(((FLOPS_PER_CELL["align_bwd"] * (pack.lens_host[s_idx] - iv + 1)
                         + FLOPS_PER_CELL["align_fwd"] * jv) * lengths[p_idx]).sum())
        nbytes += b
    report("pair_align",
           [("log_scale", got[0][:, 0], want[0][:, 0]) for got, want in outs]
           + [("logn2", got[0][:, 1:], want[0][:, 1:]) for got, want in outs], ms, plain_ms,
           (flops, nbytes),
           two_kernel_ms=kernels["align_bwd"]["ms"] + kernels["align_fwd"]["ms"])
    null2_err["pair_align"] = max_err(outs)
    print(f"# largest envelope-score and null2 log-ratio (logn2) errors against the plain "
          f"version per width class, nats: {json.dumps(null2_err)}", flush=True)

    # kernels B and C over each row's envelope as a residue window, and a
    # window of the whole sequence against the launch without one
    s_env = numpy.concatenate([g[0] for g, _env in rows])
    p_env = numpy.concatenate([g[1] for g, _env in rows])
    ranges = numpy.stack([numpy.concatenate([env[0] for _g, env in rows]) - 1,
                          numpy.concatenate([env[1] for _g, env in rows])], 1)
    whole = numpy.stack([numpy.zeros(len(s_all), numpy.int64), pack.lens_host[s_all]], 1)
    cells = float(((ranges[:, 1] - ranges[:, 0]) * lengths[p_env]).sum())
    for name, kernel, plain, key in (
            ("viterbi_pairs", viterbi_pairs, viterbi_pairs_plain, "viterbi_window"),
            ("forward_pairs", stream.forward_pairs, stream.forward_pairs_plain,
             "forward_window")):
        require(torch.equal(kernel(pack, bank, s_all, p_all, ranges=whole),
                            kernel(pack, bank, s_all, p_all)),
                f"{name}: a window of the whole sequence differs from the launch without ranges")
        got, ms = timed_ms(lambda: kernel(pack, bank, s_env, p_env, ranges=ranges), 3)
        want, plain_ms = timed_ms(lambda: plain(pack, bank, s_env, p_env, ranges=ranges), 1)
        _f, nbytes = pair_work(pack, lengths, s_env, p_env, 0, 12.0 * len(s_env))
        report(name, [(key, got, want)], ms, plain_ms, (cells * FLOPS_PER_CELL[name], nbytes),
               variant="windowed")
    print(f"# windowed pair kernels: {len(s_env)} envelope windows, {cells!r} cells; whole-"
          f"sequence windows of {len(s_all)} pairs equal the launches without ranges",
          flush=True)


def phase_long_domain_rows(device, report):
    """Kernels D-G against their plain versions on rows of up to 6,000
    residues (``LONG_SEQS``, a domain of each profile planted in the second)
    against profiles of the 1,024-, 2,048- and 4,096-node classes
    (``LONG_MODELS``), one launch a class as ``StreamDomains`` makes them:
    D, E on plain D's outputs, F, and G on plain F's planes over whole
    sequences (every residue a long chain); zeros past each row's length;
    each kernel's launches counted over these calls alone.  The plain
    versions step residue by residue, so each runs once (its time is that
    one call).  The log scales run over every residue, summed in double
    precision."""
    from gecco_tpu_torch.hmm import stream
    from gecco_tpu_torch.hmm.bank import TorchBank
    from gecco_tpu_torch.hmm.kernels import SeqPack
    from gecco_tpu_torch.hmm.synthetic import plant_domain, synthetic_profiles

    profiles = [gm for seed, m in enumerate(LONG_MODELS)
                for gm in synthetic_profiles(1, min_length=m, max_length=m, seed=70 + seed)]
    rng = numpy.random.default_rng(17)
    seqs = [rng.integers(0, 20, n).astype(numpy.int32) for n in LONG_SEQS]
    for gm, offset in zip(profiles, (100, 1800, 3700)):
        seqs[1] = plant_domain(seqs[1], gm, rng, offset=offset, max_len=min(gm.M, 1500),
                               divergence=0.2)
    bank = TorchBank.build(profiles, device)
    pack = SeqPack(seqs, device)
    lengths = bank.lengths.cpu().numpy()
    classes = bank.class_of.tolist()
    require(classes == [1024, 2048, 4096], f"long rows: classes {classes}")
    s_all = numpy.repeat(numpy.arange(len(seqs)), len(profiles))
    p_all = numpy.tile(numpy.arange(len(profiles)), len(seqs))
    groups = [(s_all[bank.class_of[p_all] == w], p_all[bank.class_of[p_all] == w])
              for w in classes]
    print(f"# long domain rows: sequences of {list(LONG_SEQS)} residues against "
          f"{list(LONG_MODELS)} nodes, one group a class {classes}", flush=True)

    def zero_past(name, s_idx, *tensors):
        """Require each ``[k, n, stride, ...]`` tensor to be zero at every
        row's residues past its length."""
        for t in tensors:
            lens = torch.as_tensor(pack.lens_host[s_idx], device=device)
            past = torch.arange(t.shape[2], device=device)[None, :] >= lens[:, None]
            require(bool((t[:, past] == 0).all()), f"long rows: {name} wrote past a row's length")

    checks = {name: [] for name in ("posterior_fwd", "posterior_bwd", "align_bwd", "align_fwd")}
    ms = dict.fromkeys(checks, 0.0)
    plain_ms = dict.fromkeys(checks, 0.0)
    work = {name: [0.0, 0.0] for name in checks}
    calls = dict.fromkeys(checks, 0)

    def held(name, fn, plain, s_idx, p_idx, *args, in_bytes=0.0, cells_to=None):
        """Kernel ``name``'s output, timed (CUDA events, once after a
        warm-up call), and its plain version's from one timed call, with
        the work of one call."""
        got, t = timed_ms(lambda: fn(pack, bank, s_idx, p_idx, *args), 1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(pack, bank, s_idx, p_idx, *args)
        end.record()
        torch.cuda.synchronize()
        t_plain = start.elapsed_time(end)
        ms[name] += t
        plain_ms[name] += t_plain
        calls[name] += 2
        out_bytes = sum(float(x.numel() * x.element_size())
                        for x in (got if isinstance(got, tuple) else (got,)))
        f, b = pair_work(pack, lengths, s_idx, p_idx, FLOPS_PER_CELL[name], out_bytes + in_bytes)
        if cells_to is not None:
            f = FLOPS_PER_CELL[name] * float(
                (numpy.asarray(cells_to, numpy.float64) * lengths[p_idx]).sum())
        work[name][0] += f
        work[name][1] += b
        return got, want

    t0 = time.perf_counter()
    TIMER.reset()
    for s_idx, p_idx in groups:
        (traj, score), (want_traj, want_score) = held(
            "posterior_fwd", stream.posterior_fwd, stream.posterior_fwd_plain, s_idx, p_idx)
        checks["posterior_fwd"] += [("trajectory", traj[:4], want_traj[:4]),
                                    ("log_scale", traj[4], want_traj[4]),
                                    ("log_scale", score, want_score)]
        zero_past("posterior_fwd", s_idx, traj)
        post, want_post = held("posterior_bwd", stream.posterior_bwd, stream.posterior_bwd_plain,
                               s_idx, p_idx, want_traj, want_score,
                               in_bytes=float(want_traj.numel() * 4 + want_score.numel() * 4))
        checks["posterior_bwd"].append(("trajectory", post, want_post))
        zero_past("posterior_bwd", s_idx, post)
        (planes, logs), (want_planes, want_logs) = held(
            "align_bwd", stream.align_bwd, stream.align_bwd_plain, s_idx, p_idx)
        checks["align_bwd"] += [("planes", planes, want_planes),
                                ("log_scale", logs, want_logs)]
        zero_past("align_bwd", s_idx, planes, logs)
        iv, jv = numpy.ones(len(s_idx), numpy.int32), pack.lens_host[s_idx]
        residues = float(jv.sum())
        got, want = held("align_fwd", stream.align_fwd, stream.align_fwd_plain, s_idx, p_idx,
                         want_planes, want_logs, iv, jv, want_score, cells_to=jv,
                         in_bytes=residues * (want_planes.shape[0] * want_planes.shape[3] * 2
                                              + want_logs.shape[0] * 4) + 12.0 * len(s_idx))
        require(torch.equal(got[1], want[1]),
                "align_fwd coordinates differ from plain on the long rows")
        checks["align_fwd"] += [("log_scale", got[0][:, 0], want[0][:, 0]),
                                ("logn2", got[0][:, 1:], want[0][:, 1:])]
        print(f"# long domain rows: class {int(bank.class_of[p_idx[0]])} held, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches = launch_counts()
    print(f"# long domain rows: launches {json.dumps(launches)}", flush=True)
    for name in checks:
        require(launches.get(name) == calls[name],
                f"long rows: {name} launched {launches.get(name)} times in {calls[name]} calls")
        report(name, checks[name], ms[name], plain_ms[name], tuple(work[name]),
               variant="long-row", launches=launches[name])


def profiled_search(pipeline, seqs, device, path):
    """One search with the launch counts set to 0 just before it and read
    just after, under ``torch.profiler`` (device activity only); prints its
    accounting and requires every kernel of ``path`` to have launched and
    every hit to be well formed.  Returns the hits, the launch counts and
    the device ms per width class of each ``CLASS_KERNELS`` kernel."""

    _ = pipeline.bank  # upload outside the timed search
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    with device_trace() as prof:
        TIMER.reset()
        t0 = time.perf_counter()
        hits = pipeline.search(seqs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = launch_counts()
    by_key = device_ms(prof)
    busy = sum(by_key.values())
    per_kernel = {name: sum(ms for key, ms in by_key.items() if fn in key)
                  for name, fn in GLOBALS.items()}
    print(f"# device ms (profiler) {json.dumps(per_kernel)}; all device work "
          f"{busy!r} ms of {seconds * 1e3!r} ms, idle share "
          f"{1 - busy / (seconds * 1e3)!r}", flush=True)
    classes = {label: class_ms(by_key, label) for label in CLASS_KERNELS if launches[label]}
    print(f"# device ms per width class (profiler) {json.dumps(classes)}", flush=True)
    print(f"# search: {seconds:.3f} s, {len(hits)} hits, "
          f"{sum(len(h.domains) for h in hits)} domains", flush=True)
    print(f"# stage_counts {json.dumps(pipeline.stage_counts)}", flush=True)
    print(f"# stage spans (s) {json.dumps(stage_span_seconds())}", flush=True)
    print(f"# stage_cells {json.dumps(pipeline.stage_cells)}", flush=True)
    print(f"# launches {json.dumps(launches)}", flush=True)
    print(f"# domains: {pipeline.host_pairs} of {pipeline.stage_counts['F3']} candidate pairs "
          f"defined by the host engine; peak device memory "
          f"{torch.cuda.max_memory_allocated(device)} bytes", flush=True)
    for name in path:
        require(launches[name] > 0, f"kernel {name} was not launched by the search")
        if not per_kernel[name]:
            print(f"# device ms of {name}: not measured (the profiler recorded none of its "
                  f"{launches[name]} launches)", flush=True)
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
    return hits, launches, classes, seconds


@contextlib.contextmanager
def recorded_domain_rows(cls=None):
    """Record the rows of each launch group of the posterior and alignment
    stages (kernels D and F, or J and K) that ``cls.define``
    (``StreamDomains`` by default, or ``PairDomains``) makes inside the
    block: yields ``{"posterior_fwd": [(s_idx, p_idx), ...], "align_bwd":
    [(s_idx, p_idx, iv, jv, total), ...]}``, host arrays (``total`` the
    device tensor the stage was given), one entry per call of each stage."""
    from gecco_tpu_torch.hmm import stream

    cls = stream.StreamDomains if cls is None else cls
    rows = {"posterior_fwd": [], "align_bwd": []}
    posteriors, align = cls._posteriors, cls._align

    def record_posteriors(self, pack, s_idx, p_idx):
        rows["posterior_fwd"].append((numpy.asarray(s_idx), numpy.asarray(p_idx)))
        return posteriors(self, pack, s_idx, p_idx)

    def record_align(self, pack, s_idx, p_idx, iv, jv, total):
        rows["align_bwd"].append(tuple(numpy.asarray(a) for a in (s_idx, p_idx, iv, jv))
                                 + (total,))
        return align(self, pack, s_idx, p_idx, iv, jv, total)

    cls._posteriors, cls._align = record_posteriors, record_align
    try:
        yield rows
    finally:
        cls._posteriors, cls._align = posteriors, align


def domain_kernels_alone(pack, bank, recorded, label, repeats):
    """Kernels D-G alone over the rows a search gave them (recorded by
    :func:`recorded_domain_rows`): each launch group's launches, prepared
    beforehand (``posterior_fwd_launches``, ``posterior_bwd_launches`` on
    D's outputs for the same rows, ``align_bwd_launches``,
    ``align_fwd_launches`` on F's planes and the group's envelopes), timed
    alone between CUDA events (mean of ``repeats`` after a warm-up) and
    summed per width class."""
    from gecco_tpu_torch.hmm import stream

    per_class = {name: {} for name in DOMAIN_PATH}

    def time_launches(name, launches):
        for width, launch in launches.items():
            per_class[name][width] = per_class[name].get(width, 0.0) + timed_ms(launch, repeats)[1]

    for s_idx, p_idx in recorded["posterior_fwd"]:
        launches, fwd = stream.posterior_fwd_launches(pack, bank, s_idx, p_idx)
        time_launches("posterior_fwd", launches)
        time_launches("posterior_bwd", stream.posterior_bwd_launches(pack, bank, s_idx, p_idx,
                                                                     *fwd)[0])
        del launches, fwd
    for s_idx, p_idx, iv, jv, total in recorded["align_bwd"]:
        launches, parked = stream.align_bwd_launches(pack, bank, s_idx, p_idx)
        time_launches("align_bwd", launches)
        time_launches("align_fwd", stream.align_fwd_launches(pack, bank, s_idx, p_idx, *parked,
                                                             iv, jv, total)[0])
        del launches, parked
    for name in DOMAIN_PATH:
        groups = recorded["posterior_fwd" if name.startswith("posterior") else "align_bwd"]
        rows = {w: int(sum((bank.class_of[g[1]] == w).sum() for g in groups))
                for w in per_class[name]}
        print(f"# kernel {name} alone over the {label}'s rows ({len(groups)} launch groups; "
              f"each launch prepared, then timed between CUDA events, ms per width class): "
              f"{json.dumps(dict(sorted(per_class[name].items())))}, total "
              f"{sum(per_class[name].values())!r} ms; rows per class "
              f"{json.dumps(dict(sorted(rows.items())))}", flush=True)


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
    from gecco_tpu_torch.hmm.bank import width_class
    from gecco_tpu_torch.hmm.calibrate import calibrate
    from gecco_tpu_torch.hmm.kernels import SeqPack
    from gecco_tpu_torch.hmm.pipeline import SearchPipeline
    from gecco_tpu_torch.hmm.synthetic import bench_workload
    from gecco_tpu_torch.orf import _native

    t0 = time.perf_counter()
    genome, profiles, seqs = bench_workload(GENOME_GENES, N_PROFILES)
    print(f"# workload: {len(genome)} bp, {len(seqs)} proteins "
          f"({sum(map(len, seqs))} residues) x {len(profiles)} profiles "
          f"in {time.perf_counter() - t0:.3f} s; gene calling on the "
          f"{_native.path()} ORF path", flush=True)
    TIMER.reset()
    t0 = time.perf_counter()
    calibrate(profiles, device=device)
    torch.cuda.synchronize()
    calibrate_s = time.perf_counter() - t0
    launches = launch_counts()
    classes = len({width_class(gm.M) for gm in profiles})
    print(f"# calibrate (port, kernels A and H): {calibrate_s:.3f} s; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    require(launches["ssv_filter"] == classes and launches["dense_scores"] == 2 * classes,
            f"calibrate made {launches} launches, not A once and H twice a width class")
    require(launches["viterbi_pairs"] == launches["forward_pairs"] == 0,
            "calibrate launched kernel B or C")

    pipeline = SearchPipeline(profiles, device=device, Z=N_PROFILES, domZ=N_PROFILES,
                              backend="cuda")
    with recorded_domain_rows() as domain_rows:
        hits, launches, _classes, search_s = profiled_search(pipeline, seqs, device,
                                                             DEFAULT_PATH)
    # before the next search replaces them
    candidates, search_counts = list(pipeline.candidate_pairs), dict(pipeline.stage_counts)
    for name in ("ssv_filter", "viterbi_pairs"):
        require(launches[name] == len(pipeline.bank.classes),
                f"{name} made {launches[name]} launches, not one per width class")
    for stage, count in FUNNEL.items():
        require(pipeline.stage_counts.get(stage) == count,
                f"funnel at {stage}: {pipeline.stage_counts.get(stage)} != {count}")
    forward_on_search(pipeline, seqs, device, calibrate_s)
    domain_kernels_alone(SeqPack(seqs, device), pipeline.bank, domain_rows, "default search", 5)
    compare_with_plain(pipeline, profiles, seqs[:HEAD], device)
    state.update(genome=genome, profiles=profiles, seqs=seqs, launches=launches,
                 hits={(h.sequence_index, h.profile.name) for h in hits},
                 bank=pipeline.bank, candidates=candidates, search_s=search_s,
                 search_hits=[hit_record(h) for h in hits],
                 search_counts=search_counts)


def hit_record(h):
    """``(sequence, profile, score, domain coordinates, domain bits)`` of a hit."""
    return (h.sequence_index, h.profile.name, h.score,
            [(d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to)
             for d in h.domains], [d.bitscore for d in h.domains])


def forward_on_search(pipeline, seqs, device, calibrate_s):
    """Kernel C per width class between CUDA events on the pairs the
    search's F3 rescored; kernel H per width class between CUDA events, in
    both semirings, on the all-pairs launches of ``calibrate`` (256
    background sequences of 256 residues against every profile), printed
    beside calibrate's wall."""
    from gecco_tpu_torch.hmm.calibrate import background_sequences
    from gecco_tpu_torch.hmm.kernels import SeqPack, dense_nodes, dense_scores
    from gecco_tpu_torch.hmm.stream import forward_launches

    bank = pipeline.bank
    lengths = bank.lengths.cpu().numpy()
    nodes = dense_nodes(bank)  # kernel C's rows are kernel H's
    pack = SeqPack(seqs, device)
    s_idx, p_idx = pipeline.rescored_pairs
    require(len(s_idx) == FUNNEL["F2"], f"{len(s_idx)} pairs rescored, not {FUNNEL['F2']}")
    per_class = pair_class_rates("forward_pairs on the F3 pairs of the search (CUDA events)",
                                 forward_launches, pack, bank, s_idx, p_idx, nodes, 3)
    work = pair_work(pack, lengths, s_idx, p_idx, FLOPS_PER_CELL["forward_pairs"],
                     4.0 * len(s_idx))
    print(f"# kernel forward_pairs on the F3 pairs: {sum(per_class.values())!r} ms (CUDA "
          f"events, summed over classes), {json.dumps(bound(*work))} ({work[0]!r} flops, "
          f"{work[1]!r} bytes)", flush=True)
    cal = SeqPack(background_sequences(), device)
    total = {}
    for semiring in ("viterbi", "forward"):
        viterbi = semiring == "viterbi"
        per_class = class_events_ms(lambda b: dense_scores(cal, b, viterbi=viterbi), bank, 1)
        print_class_rates(f"dense_scores ({semiring}) in calibrate (CUDA events)",
                          per_class, cal, bank, nodes)
        total[semiring] = sum(per_class.values())
    work = all_pairs_work(cal, lengths, FLOPS_PER_CELL["dense_forward"])
    print(f"# calibrate: {calibrate_s:.3f} s wall; its kernel H launches alone "
          f"{json.dumps(total)} ms (CUDA events, {cal.S * bank.P} pairs a semiring), "
          f"Forward's {json.dumps(bound(*work))}", flush=True)


def phase_max_filter(device, state):
    """hmmsearch ``--max``: every pair Forward-scored by kernel H."""
    from gecco_tpu_torch.hmm.kernels import SeqPack, dense_nodes
    from gecco_tpu_torch.hmm.pipeline import SearchPipeline

    profiles, seqs = state["profiles"], state["seqs"]
    pipeline = SearchPipeline(profiles, device=device, Z=N_PROFILES, domZ=N_PROFILES,
                              max_filter=True, backend="cuda")
    with recorded_domain_rows() as domain_rows:
        hits, launches, classes, _s = profiled_search(pipeline, seqs, device, MAX_FILTER_PATH)
    require(launches["dense_scores"] == len(pipeline.bank.classes),
            f"dense_scores made {launches['dense_scores']} launches, not one per width class")
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
    moved = {key: pipeline.stage_counts[key] - count
             for key, count in MAX_FILTER_FUNNEL.items()}
    print(f"# max_filter against the record {json.dumps(MAX_FILTER_FUNNEL)}: "
          f"{json.dumps(moved)}", flush=True)
    require(not any(moved.values()), f"max_filter funnel moved from the record: {moved}")
    pack = SeqPack(seqs, device)
    print_class_rates("dense_scores on the search (profiler)",
                      classes.get("dense_scores", {}), pack, pipeline.bank, dense_nodes(pipeline.bank))
    work = all_pairs_work(pack, pipeline.bank.lengths.cpu().numpy(),
                          FLOPS_PER_CELL["dense_forward"])
    print(f"# kernel dense_scores on the search: {json.dumps(bound(*work))} "
          f"({work[0]!r} flops, {work[1]!r} bytes)", flush=True)
    check_dense_whole_pack(pack, pipeline.bank)
    domain_kernels_alone(pack, pipeline.bank, domain_rows, "max_filter search", 1)
    compare_with_plain(pipeline, profiles, seqs[:HEAD], device, max_filter=True)
    state.update(max_launches=launches)


def tile_rows(S, tile, seed=7, extra=9):
    """Rows of a pack of ``S`` sequences whose kernel H scores are held
    against the plain version: the first two and last two rows of the
    first, second, middle and last full tiles of ``tile`` sequences, the
    whole last tile (ragged where ``tile`` does not divide ``S``), and
    ``extra`` rows drawn from a seeded generator."""
    n_tiles = -(-S // tile)
    rows = set(range((n_tiles - 1) * tile, S))
    for t in sorted({0, 1, n_tiles // 2, n_tiles - 2} - {-1, n_tiles - 1}):
        rows |= {t * tile, t * tile + 1, (t + 1) * tile - 2, (t + 1) * tile - 1}
    rows |= set(numpy.random.default_rng(seed).choice(S, min(extra, S), replace=False).tolist())
    return sorted(r for r in rows if 0 <= r < S)


def check_dense_whole_pack(pack, bank):
    """Kernel H over the search's whole pack in both semirings: its device
    ms per width class (CUDA events) with rates, and the rows of
    :func:`tile_rows` (full tiles, their block offsets and the ragged last
    tile) held against the plain version on those sequences."""
    from gecco_tpu_torch.hmm.kernels import (
        DENSE_TILE, SeqPack, dense_nodes, dense_scores, dense_scores_plain)

    rows = tile_rows(pack.S, DENSE_TILE)
    xs, lens = pack.xs.cpu().numpy(), pack.lens_host
    offsets = pack.offsets.cpu().numpy()
    sample = SeqPack([xs[offsets[r]:offsets[r] + lens[r]] for r in rows], pack.device)
    tiles = sorted({r // DENSE_TILE for r in rows})
    for semiring in ("forward", "viterbi"):
        viterbi = semiring == "viterbi"
        per_class = class_events_ms(lambda b: dense_scores(pack, b, viterbi=viterbi), bank, 1)
        print_class_rates(f"dense_scores ({semiring}) on the whole pack (CUDA events)",
                          per_class, pack, bank, dense_nodes(bank))
        got = dense_scores(pack, bank, viterbi=viterbi)[torch.as_tensor(rows, device=pack.device)]
        want = dense_scores_plain(sample, bank, viterbi=viterbi)
        finite = torch.isfinite(want)
        require(bool(torch.equal(torch.isfinite(got), finite)),
                f"dense {semiring}: non-finite scores differ from the plain version's")
        err = float((got[finite] - want[finite]).abs().max())
        tol = TOL[f"dense_{semiring}"]
        print(f"# kernel dense_scores ({semiring}) on the whole pack ({pack.S} proteins, "
              f"tiles of {DENSE_TILE}): {len(rows)} rows of tiles {tiles} against the plain "
              f"version: max abs {err!r} (tol {tol})", flush=True)
        require(err <= tol, f"dense {semiring} on the whole pack disagrees with plain: {err}")


def phase_msv_search(device, state):
    """``filter_stage="msv"``: kernel I in place of kernel A, then the
    default path's kernels; with and without the bias filter."""
    from gecco_tpu_torch.hmm.kernels import SeqPack
    from gecco_tpu_torch.hmm.pipeline import SearchPipeline

    profiles, seqs = state["profiles"], state["seqs"]
    pipeline = SearchPipeline(profiles, device=device, Z=N_PROFILES, domZ=N_PROFILES,
                              filter_stage="msv", backend="cuda")
    hits, launches, _classes, _s = profiled_search(pipeline, seqs, device, MSV_PATH)
    counts = pipeline.stage_counts
    require(launches["msv_filter"] == len(pipeline.bank.classes),
            f"msv_filter made {launches['msv_filter']} launches, not one per width class")
    require(launches["ssv_filter"] == 0, "the MSV search launched the SSV kernel")
    require(counts["pairs"] == FUNNEL["pairs"] and counts["F1"] >= FUNNEL["F1"],
            f"MSV funnel {counts}: F1 below the SSV search's {FUNNEL['F1']}")
    for stage, count in MSV_FUNNEL.items():
        require(counts.get(stage) == count,
                f"MSV funnel at {stage}: {counts.get(stage)} != {count}")
    got = {(h.sequence_index, h.profile.name) for h in hits}
    print(f"# msv: {len(got)} hits, {len(got & state['hits'])} of them in the default "
          f"search's {len(state['hits'])}", flush=True)
    work = all_pairs_work(SeqPack(seqs, device), pipeline.bank.lengths.cpu().numpy(),
                          FLOPS_PER_CELL["msv_filter"], planes=21)
    print(f"# kernel msv_filter on the search: {json.dumps(bound(*work))} "
          f"({work[0]!r} flops, {work[1]!r} bytes)", flush=True)
    check_msv_whole_pack(SeqPack(seqs, device), pipeline.bank)
    compare_with_plain(pipeline, profiles, seqs[:HEAD], device, filter_stage="msv")
    nobias = SearchPipeline(profiles, device=device, Z=N_PROFILES, domZ=N_PROFILES,
                            filter_stage="msv", bias_filter=False, backend="cuda")
    TIMER.reset()
    compare_with_plain(nobias, profiles, seqs[:HEAD], device, filter_stage="msv",
                       bias_filter=False)
    require(launch_counts()["msv_filter"] > 0, "the MSV search without bias skipped kernel I")
    state.update(msv_launches=launches)


def check_msv_whole_pack(pack, bank):
    """Kernel I over the search's whole pack: its device ms per width class
    (CUDA events) with rates, and the rows of :func:`tile_rows` (full
    tiles of the largest class tile, which the smaller tiles divide, their
    block offsets and the ragged last tile, in the kernel's order of
    sequences) held against the plain version bit for bit."""
    from gecco_tpu_torch.hmm.kernels import (
        SeqPack, msv_filter, msv_filter_plain, msv_nodes, msv_tile)

    per_class = class_events_ms(lambda b: msv_filter(pack, b), bank, 1)
    print_class_rates("msv_filter on the whole pack (CUDA events)", per_class, pack, bank,
                      msv_nodes(bank))
    order = pack.by_length().cpu().numpy()
    tile = max(msv_tile(width) for width, _idx in bank.classes if width < 4096)
    slots = tile_rows(pack.S, tile)
    rows = [int(order[k]) for k in slots]
    xs, lens = pack.xs.cpu().numpy(), pack.lens_host
    offsets = pack.offsets.cpu().numpy()
    sample = SeqPack([xs[offsets[r]:offsets[r] + lens[r]] for r in rows], pack.device)
    got = msv_filter(pack, bank)[torch.as_tensor(rows, device=pack.device)]
    want = msv_filter_plain(sample, bank)
    differ = int((got != want).sum())
    print(f"# kernel msv_filter on the whole pack ({pack.S} proteins, tiles of {tile}): "
          f"{len(rows)} rows of tiles {sorted({k // tile for k in slots})} against the "
          f"plain version: {differ} scores differ (bit for bit), max abs "
          f"{float((got - want).abs().max())!r}", flush=True)
    require(differ == 0, f"msv_filter on the whole pack differs from plain in {differ} scores")


def phase_pair_domains(device, state):
    """``PairDomains`` (kernels J and K) over the default search's F3
    candidates against ``StreamDomains`` (kernels D-G) and plain PyTorch;
    kernels C and B over every envelope found as a residue window."""
    from gecco_tpu_torch.hmm.domains import PairDomains
    from gecco_tpu_torch.hmm.kernels import (
        SeqPack, dense_nodes, viterbi_launches, viterbi_pairs, viterbi_pairs_plain)
    from gecco_tpu_torch.hmm.stream import (
        StreamDomains, forward_launches, forward_pairs, forward_pairs_plain)

    profiles, seqs, bank, pairs = (state[k] for k in ("profiles", "seqs", "bank", "candidates"))
    require(len(pairs) == FUNNEL["F3"], f"{len(pairs)} candidates, not {FUNNEL['F3']}")
    pack = SeqPack(seqs, device)

    def define(domains, pairs):
        """One ``define`` under the profiler, the launch counts set to 0 just
        before; also records the rows of each launch group."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        with recorded_domain_rows(type(domains)) as rows, device_trace() as prof:
            TIMER.reset()
            t0 = time.perf_counter()
            out = domains.define(seqs, pairs, pack)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        by_key = device_ms(prof)
        per_kernel = {name: sum(ms for key, ms in by_key.items() if fn in key)
                      for name, fn in GLOBALS.items()}
        return out, launch_counts(), {k: v for k, v in per_kernel.items() if v}, seconds, \
            torch.cuda.max_memory_allocated(device), by_key, rows

    def same(got, want, what):
        require(sorted(got) == sorted(want), f"PairDomains pairs differ from {what}")
        count = 0
        for key, doms in want.items():
            coords = [(d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to)
                      for d in doms]
            require([(d.ienv, d.jenv, d.target_from, d.target_to, d.hmm_from, d.hmm_to)
                     for d in got[key]] == coords, f"domains of {key} differ from {what}")
            for a, b in zip(got[key], doms):
                require(abs(a.bitscore - b.bitscore) <= 1e-2,
                        f"domain score {a.bitscore} != {what} {b.bitscore}")
            count += len(doms)
        return count

    for turn in range(2):     # stream, pair, pair, stream: both on a warm card
        order = (StreamDomains, PairDomains) if turn == 0 else (PairDomains, StreamDomains)
        for cls in order:
            domains = cls(bank, profiles, backend="cuda")
            out, launches, ms, seconds, peak, by_key, rows = define(domains, pairs)
            print(f"# {cls.__name__}.define over {len(pairs)} candidates: {seconds!r} s, "
                  f"{sum(map(len, out.values()))} domains, host_pairs {domains.host_pairs}, "
                  f"peak device memory {peak} bytes, launches "
                  f"{json.dumps({k: v for k, v in launches.items() if v})}, device ms "
                  f"(profiler) {json.dumps(ms)}", flush=True)
            path = PAIR_PATH if cls is PairDomains else DOMAIN_PATH
            print(f"# {cls.__name__}.define device ms per width class (profiler) "
                  f"{json.dumps({name: class_ms(by_key, name) for name in path})}", flush=True)
            if cls is PairDomains:
                got, pair_launches, pair_rows = out, launches, rows
            else:
                want, stream_rows = out, rows
    for name in PAIR_PATH:
        require(pair_launches[name] > 0, f"kernel {name} was not launched by PairDomains")
    for name in DOMAIN_PATH:
        require(pair_launches[name] == 0, f"PairDomains launched the stream kernel {name}")
    count = same(got, want, "StreamDomains")
    print(f"# PairDomains: {count} domains of {len(pairs)} candidates equal StreamDomains' "
          f"(coordinates equal, bit scores within 1e-2)", flush=True)

    head = [(s, p) for s, p in pairs if s < HEAD]
    plain = PairDomains(bank, profiles, backend="torch").define(seqs, head, pack)
    count = same({key: got[key] for key in plain}, plain, "plain PyTorch")
    print(f"# reference (PairDomains on plain torch, {len(head)} candidates of the first "
          f"{HEAD} proteins): {count} domains agree", flush=True)

    pair_kernels_alone(pack, bank, pair_rows, 5)
    domain_kernels_alone(pack, bank, stream_rows, "phase 6 define", 5)
    domain_bounds(pack, bank, pairs, want)

    # every envelope found, rescored as a residue window
    rows = [(s, p, d.ienv - 1, d.jenv) for (s, p), doms in got.items() for d in doms]
    s_idx, p_idx = (numpy.array([row[k] for row in rows]) for k in (0, 1))
    ranges = numpy.array([row[2:] for row in rows])
    lengths = bank.lengths.cpu().numpy()
    cells = float(((ranges[:, 1] - ranges[:, 0]) * lengths[p_idx]).sum())
    for name, kernel, plain_fn, launches_of, nodes, key in (
            ("forward_pairs", forward_pairs, forward_pairs_plain, forward_launches,
             dense_nodes(bank), "forward_window"),
            ("viterbi_pairs", viterbi_pairs, viterbi_pairs_plain, viterbi_launches,
             bank.class_of, "viterbi_window")):
        window = kernel(pack, bank, s_idx, p_idx, ranges=ranges)
        err = float((window - plain_fn(pack, bank, s_idx, p_idx, ranges=ranges)).abs().max())
        full = kernel(pack, bank, s_idx, p_idx)
        require(bool(torch.isfinite(window).all()) and err <= TOL[key],
                f"{name} over the envelopes disagrees with its plain version: {err}")
        per_class = pair_class_rates(f"{name} over the envelope windows (CUDA events)",
                                     launches_of, pack, bank, s_idx, p_idx, nodes, 3,
                                     ranges=ranges)
        _f, nbytes = pair_work(pack, lengths, s_idx, p_idx, 0, 12.0 * len(s_idx))
        print(f"# {name} over {len(rows)} envelope windows: max abs {err!r} against plain "
              f"(tol {TOL[key]}); mean window score {float(window.mean())!r} nats, whole "
              f"sequence {float(full.mean())!r}; {sum(per_class.values())!r} ms (CUDA events), "
              f"{json.dumps(bound(cells * FLOPS_PER_CELL[name], nbytes))}", flush=True)
    state.update(pair_launches=pair_launches)


def domain_work(pack, lengths, s_c, p_c, env):
    """``{kernel: (flops, bytes)}`` of the domain kernels: D, E and J over
    the candidate pairs ``(s_c, p_c)``, F, G and K over the envelope rows
    ``env`` (``(s, p, ienv, jenv)`` arrays), cells counted as phase 2
    counts them; inputs read once, the outputs a row writes
    (trajectories, posteriors, bfloat16 planes, scores) written once."""
    s_e, p_e, iv, jv = env
    L_c, L_e = pack.lens_host[s_c].astype(numpy.float64), pack.lens_host[s_e].astype(numpy.float64)
    cells_e = L_e * lengths[p_e]
    # bytes a residue a row: D's five trajectories, E's and J's posteriors
    # (mocc, pB; J also its score's trajectory), and per cell F's two
    # bfloat16 planes, which G reads back over the envelope
    work = {
        "posterior_fwd": pair_work(pack, lengths, s_c, p_c, FLOPS_PER_CELL["posterior_fwd"],
                                   20.0 * L_c.sum() + 4.0 * len(s_c)),
        "posterior_bwd": pair_work(pack, lengths, s_c, p_c, FLOPS_PER_CELL["posterior_bwd"],
                                   8.0 * L_c.sum() + 20.0 * L_c.sum()),
        "pair_posterior": pair_work(pack, lengths, s_c, p_c, FLOPS_PER_CELL["pair_posterior"],
                                    12.0 * L_c.sum() + 4.0 * len(s_c)),
    }
    f_flops, f_bytes = pair_work(pack, lengths, s_e, p_e, FLOPS_PER_CELL["align_bwd"],
                                 4.0 * cells_e.sum())
    work["align_bwd"] = (f_flops, f_bytes)
    g_cells = float((jv * lengths[p_e]).sum())
    work["align_fwd"] = (FLOPS_PER_CELL["align_fwd"] * g_cells,
                         pair_work(pack, lengths, s_e, p_e, 0,
                                   4.0 * float(((jv - iv + 1) * lengths[p_e]).sum()))[1])
    k_flops = float(((FLOPS_PER_CELL["align_bwd"] * (L_e - iv + 1)
                      + FLOPS_PER_CELL["align_fwd"] * jv) * lengths[p_e]).sum())
    work["pair_align"] = (k_flops, pair_work(pack, lengths, s_e, p_e, 0, 100.0 * len(s_e))[1])
    return work


def domain_bounds(pack, bank, pairs, domains):
    """The bounds (:func:`bound`) of the domain kernels on the main path's
    work (:func:`domain_work`): kernels D, E and J over every F3 candidate
    pair, F and G (and K, which does both) over each envelope ``domains``
    holds (the domains ``StreamDomains.define`` found on them)."""
    lengths = bank.lengths.cpu().numpy().astype(numpy.float64)
    s_c, p_c = (numpy.array([pair[k] for pair in pairs], numpy.int64) for k in (0, 1))
    env = [(s, p, d.ienv, d.jenv) for (s, p), doms in domains.items() for d in doms]
    env = tuple(numpy.array([row[k] for row in env], numpy.int64) for k in range(4))
    work = domain_work(pack, lengths, s_c, p_c, env)
    print(f"# domain kernels' bounds on phase 6's define ({len(s_c)} candidate pairs, "
          f"{len(env[0])} envelopes): " + json.dumps(
              {name: {**bound(*w), "flops": w[0], "bytes": w[1]} for name, w in work.items()}),
          flush=True)


def pair_kernels_alone(pack, bank, recorded, repeats):
    """Kernels J and K alone over the rows ``PairDomains.define`` gave them
    (recorded by :func:`recorded_domain_rows`): each launch group's
    launches, prepared beforehand (``pair_posterior_launches`` with
    ``emit_pe=False``, as ``define`` calls it; ``pair_align_launches`` on
    the group's envelopes and totals), timed alone between CUDA events
    (mean of ``repeats`` after a warm-up) and summed per width class, with
    each class's rows and bound (:func:`domain_work`)."""
    from gecco_tpu_torch.hmm import domains

    lengths = bank.lengths.cpu().numpy().astype(numpy.float64)
    per_class = {name: {} for name in PAIR_PATH}
    rows = {name: {} for name in PAIR_PATH}
    work = {name: {} for name in PAIR_PATH}

    def add(name, width, ms, n, w):
        per_class[name][width] = per_class[name].get(width, 0.0) + ms
        rows[name][width] = rows[name].get(width, 0) + n
        old = work[name].get(width, (0.0, 0.0))
        work[name][width] = (old[0] + w[0], old[1] + w[1])

    none = numpy.zeros(0, numpy.int64)
    for s_idx, p_idx in recorded["posterior_fwd"]:
        launches, _out = domains.pair_posterior_launches(pack, bank, s_idx, p_idx, emit_pe=False)
        (width,), (launch,) = launches.keys(), launches.values()   # one class a group
        w = domain_work(pack, lengths, s_idx, p_idx, (none,) * 4)["pair_posterior"]
        add("pair_posterior", width, timed_ms(launch, repeats)[1], len(s_idx), w)
        del launches, _out
    for s_idx, p_idx, iv, jv, total in recorded["align_bwd"]:
        launches, _out = domains.pair_align_launches(pack, bank, s_idx, p_idx, iv, jv, total)
        (width,), (launch,) = launches.keys(), launches.values()
        w = domain_work(pack, lengths, none, none, (s_idx, p_idx, iv, jv))["pair_align"]
        add("pair_align", width, timed_ms(launch, repeats)[1], len(s_idx), w)
        del launches, _out
    for name, stage in zip(PAIR_PATH, ("posterior_fwd", "align_bwd")):
        bounds = {width: bound(*w)["bound_ms"] for width, w in sorted(work[name].items())}
        print(f"# kernel {name} alone over phase 6's rows ({len(recorded[stage])} "
              f"launch groups; each launch prepared, then timed between CUDA events, ms per "
              f"width class): {json.dumps(dict(sorted(per_class[name].items())))}, total "
              f"{sum(per_class[name].values())!r} ms; rows per class "
              f"{json.dumps(dict(sorted(rows[name].items())))}; bound ms per class "
              f"{json.dumps(bounds)}", flush=True)


def phase_cli(device, state):
    """``gecco-tpu-torch run`` on the genome, in ``state["workdir"]``, whose
    inputs and output phase 8 takes up."""
    from gecco_tpu_torch.cli import main
    from gecco_tpu_torch.hmm.synthetic import write_library

    tmp = state["workdir"]
    bank_path = os.path.join(tmp, "bank.h3m")
    write_library(bank_path, state["profiles"])
    genome_path = os.path.join(tmp, "genome.fna")
    with open(genome_path, "w") as f:
        f.write(">genome\n")
        genome = state["genome"]
        for i in range(0, len(genome), 80):
            f.write(genome[i : i + 80] + "\n")
    out = os.path.join(tmp, "run")
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
    state.update(genome_path=genome_path, bank_path=bank_path, run_dir=out)


# --- phase 8: CRF training --------------------------------------------------------

def training_corpus(names, pool, contigs, genes_per_contig, seed):
    """``contigs`` contigs of ``genes_per_contig`` genes, made from ``seed``:
    each gene carries 0-4 domains named from ``names`` outside ``pool``,
    except in one to three planted runs of 10-40 genes a contig, whose
    genes carry 1-4 domains named from ``pool`` (``names`` indices); every
    domain and gene is labelled 1 inside a run, 0 outside
    (``tests/test_train.py``'s ``_synthetic_genes`` at scale)."""
    from gecco_tpu_torch.model import Domain, Gene, Protein, Strand
    from gecco_tpu_torch.seq import Seq, SeqRecord

    rng = numpy.random.default_rng(seed)
    background = numpy.setdiff1d(numpy.arange(len(names)), pool)
    genes = []
    for c in range(contigs):
        source = SeqRecord(id=f"contig{seed}_{c:04}", seq=Seq(""))
        inside = numpy.zeros(genes_per_contig, dtype=bool)
        for _ in range(int(rng.integers(1, 4))):
            start = int(rng.integers(0, genes_per_contig - 40))
            inside[start : start + int(rng.integers(10, 41))] = True
        counts = rng.integers(0, 5, size=genes_per_contig)
        counts[inside] = rng.integers(1, 5, size=int(inside.sum()))
        drawn = numpy.where(
            inside[:, None], pool[rng.integers(0, len(pool), size=(genes_per_contig, 4))],
            background[rng.integers(0, len(background), size=(genes_per_contig, 4))])
        for i in range(genes_per_contig):
            p = 1.0 if inside[i] else 0.0
            domains = [Domain(names[k], 1 + 100 * d, 90 + 100 * d, "Pfam", 1e-20, 1e-22,
                              probability=p)
                       for d, k in enumerate(drawn[i, : counts[i]])]
            protein = Protein(f"{source.id}_{i + 1}", Seq("M"), domains)
            genes.append(Gene(source, 1000 * i + 1, 1000 * i + 900, Strand.Coding, protein,
                              _probability=p))
    return genes


def stripped(genes):
    """``genes`` with the labels taken off, as a prediction sees them."""
    from gecco_tpu_torch.model import Gene

    return [Gene(g.source, g.start, g.end, g.strand, g.protein.with_domains(
        [d.with_probability(None) for d in g.protein.domains]), dict(g.qualifiers), None)
        for g in genes]


@contextlib.contextmanager
def fit_probes():
    """Wrap the stages of a fit: the Fisher selection, ``_build_instances``
    and each evaluation of the objective and gradient (host seconds, and
    device ms between CUDA events recorded before its upload and after its
    download).  Yields the record, which also keeps the last evaluation's
    arguments."""
    from gecco_tpu_torch.crf import select, train

    record = {"select_s": 0.0, "instances_s": 0.0, "evaluations": 0, "evaluation_s": 0.0,
              "device_ms": 0.0, "first_evaluation": None, "instances_end": None, "args": None}
    significance, instances, value_and_grad = (
        select.fisher_significance, train._build_instances, train._value_and_grad)

    def timed_significance(*args, **kwargs):
        t0 = time.perf_counter()
        out = significance(*args, **kwargs)
        record["select_s"] += time.perf_counter() - t0
        return out

    def timed_instances(*args, **kwargs):
        t0 = time.perf_counter()
        out = instances(*args, **kwargs)
        record["instances_end"] = time.perf_counter()
        record["instances_s"] += record["instances_end"] - t0
        return out

    def timed_value_and_grad(*args):
        t0 = time.perf_counter()
        if record["first_evaluation"] is None:
            record["first_evaluation"] = t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = value_and_grad(*args)
        end.record()
        end.synchronize()
        record["evaluation_s"] += time.perf_counter() - t0
        record["device_ms"] += start.elapsed_time(end)
        record["evaluations"] += 1
        record["args"] = args
        return out

    select.fisher_significance = timed_significance
    train._build_instances = timed_instances
    train._value_and_grad = timed_value_and_grad
    try:
        yield record
    finally:
        select.fisher_significance = significance
        train._build_instances = instances
        train._value_and_grad = value_and_grad


def probabilities(crf, genes, device):
    return numpy.array([g.average_probability
                        for g in crf.predict_probabilities(stripped(genes), device=device)])


def phase_train(device, state):
    """8a: the full-width fit on the card; 8b: the same fit on the card and
    on the CPU; 8c: the CLI's other five subcommands on the card."""
    from gecco_tpu_torch.crf import ClusterCRF, train

    shipped = numpy.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "gecco_tpu_torch", "data", "crf_model.npz"),
                         allow_pickle=True)
    names = [str(n) for n in shipped["sig_names"]]
    width = len(shipped["attr_names"])
    settings = {key: shipped[key].item() for key in
                ("feature_type", "window_size", "window_step", "algorithm", "c1", "c2")}
    rng = numpy.random.default_rng(TRAIN_SEED)
    pool = rng.choice(len(names), size=CLUSTER_POOL, replace=False)

    t0 = time.perf_counter()
    corpus = training_corpus(names, pool, TRAIN_CONTIGS + HELD_OUT, TRAIN_GENES, TRAIN_SEED)
    held_out = corpus[TRAIN_CONTIGS * TRAIN_GENES :]
    corpus = corpus[: TRAIN_CONTIGS * TRAIN_GENES]
    print(f"# 8a corpus: {TRAIN_CONTIGS} contigs x {TRAIN_GENES} genes "
          f"({sum(len(g.protein.domains) for g in corpus)} domains, "
          f"{sum(g.average_probability == 1.0 for g in corpus)} planted genes) from "
          f"{len(names)} names, a cluster pool of {len(pool)}, {HELD_OUT} contigs held out; "
          f"built in {time.perf_counter() - t0:.3f} s", flush=True)

    crf = ClusterCRF(**settings)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with fit_probes() as probe:
        t0 = time.perf_counter()
        crf.fit(corpus, device=device, select=width / len(names))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _x, idx, y, c2 = probe["args"]
    state.update(windows=(idx, y, len(crf.attr_names)))
    n_windows, window, dmax = idx.shape
    index_s = probe["first_evaluation"] - probe["instances_end"]
    per_evaluation = probe["device_ms"] / probe["evaluations"]
    print(f"# 8a fit ({json.dumps(settings)}, select {width}/{len(names)}): {n_windows} windows "
          f"of {window} genes, vocabulary {len(crf.attr_names)}, index tensor "
          f"{list(idx.shape)} {idx.dtype} ({idx.numel() * idx.element_size()} bytes)", flush=True)
    print(f"# 8a seconds: fit {fit_s!r}, of it host: selection {probe['select_s']!r}, "
          f"instances {probe['instances_s']!r}, vocabulary and index {index_s!r}; "
          f"{probe['evaluations']} evaluations, {probe['evaluation_s']!r} s in them, "
          f"{per_evaluation!r} device ms each (CUDA events around upload, objective, "
          f"gradient and download); peak device memory {peak} bytes", flush=True)
    with device_trace() as prof:
        t0 = time.perf_counter()
        for _ in range(EVALUATIONS_TRACED):
            train._value_and_grad(*probe["args"])
        seconds = time.perf_counter() - t0
    busy = sum(device_ms(prof).values()) / EVALUATIONS_TRACED
    host_share = 1 - probe["evaluations"] * busy / 1e3 / fit_s
    print(f"# 8a one evaluation (profiler, {EVALUATIONS_TRACED} at the final point): "
          f"{busy!r} device ms busy of {seconds * 1e3 / EVALUATIONS_TRACED!r} ms wall; the "
          f"fit's host share (1 - evaluations x busy ms / fit ms) {host_share!r}", flush=True)
    zero = float(train.nll(torch.zeros((len(crf.attr_names) + 1, 2), device=device),
                           torch.zeros((2, 2), device=device), idx, y, c2))
    nonzero = int((crf.state != 0).any(axis=1).sum())
    print(f"# 8a objective {crf.last_objective_!r} (nll(0) {zero!r}), {nonzero} of "
          f"{len(crf.attr_names)} features with a non-zero weight", flush=True)
    require(numpy.isfinite(crf.last_objective_) and crf.last_objective_ < zero,
            f"8a objective {crf.last_objective_} not below nll(0) {zero}")
    require(len(crf.attr_names) <= width, f"8a kept {len(crf.attr_names)} > {width} features")
    p = probabilities(crf, held_out, device)
    truth = numpy.array([g.average_probability == 1.0 for g in held_out])
    print(f"# 8a held out ({HELD_OUT} contigs, predicted on {device}): mean probability "
          f"{float(p[truth].mean())!r} of {int(truth.sum())} planted genes, "
          f"{float(p[~truth].mean())!r} of "
          f"{int((~truth).sum())} others", flush=True)
    require(p[truth].mean() > 0.8 and p[~truth].mean() < 0.2, "8a model does not separate")

    cut_corpus = training_corpus(names, pool, CUT_CONTIGS, CUT_GENES, TRAIN_SEED + 1)
    for algorithm, iterations in (("lbfgs", 200), ("adam", 300)):
        fits = {}
        runs = [(device, 42), (torch.device("cpu"), 42)]
        if algorithm == "lbfgs":
            runs.append((device, 43))  # the same windows in another order
        for where, seed in runs:
            crf = ClusterCRF("protein", algorithm=algorithm,
                             window_size=settings["window_size"], c1=0.0, c2=0.05)
            with fit_probes() as probe:
                t0 = time.perf_counter()
                crf.fit(cut_corpus, device=where, max_iterations=iterations, seed=seed)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            fits[where.type, seed] = (crf, probabilities(crf, cut_corpus, where), probe["args"])
            print(f"# 8b {algorithm} on {where.type} (windows shuffled by seed {seed}): "
                  f"{seconds:.3f} s, {probe['evaluations']} evaluations, objective "
                  f"{crf.last_objective_!r}", flush=True)
        card, cpu = fits[device.type, 42], fits["cpu", 42]
        require(card[0].attr_names == cpu[0].attr_names, f"8b {algorithm}: vocabularies differ")
        if algorithm == "lbfgs":  # Adam evaluates the same objective
            same_function(card, cpu)
        gaps = fit_gaps(card, cpu)
        print(f"# 8b {algorithm} card against CPU ({CUT_CONTIGS} contigs x {CUT_GENES} genes, "
              f"{len(card[0].attr_names)} features, {iterations} iterations at most): "
              f"{json.dumps(gaps)} (bounds: objective {FIT_OBJECTIVE_RTOL} relative, weights "
              f"{FIT_WEIGHT_ATOL}, probabilities {FIT_PROBABILITY_ATOL})", flush=True)
        within = (gaps["objective_rel"] <= FIT_OBJECTIVE_RTOL
                  and max(gaps["state_abs"], gaps["trans_abs"]) <= FIT_WEIGHT_ATOL
                  and gaps["probability_abs"] <= FIT_PROBABILITY_ATOL)
        if algorithm == "adam":
            require(within, f"8b adam: the card's fit differs from the CPU's: {gaps}")
        else:
            print(f"# 8b lbfgs card against card, windows in another order: "
                  f"{json.dumps(fit_gaps(card, fits[device.type, 43]))}; card against CPU "
                  f"{'within' if within else 'outside'} the bounds (not required: the "
                  f"copied L-BFGS stops short of the optimum on this corpus, where the "
                  f"order of float32 sums alone moves its end point)", flush=True)
    phase_train_cli(device, state, cut_corpus)


def fit_gaps(a, b):
    """How far two fits ``(crf, probabilities, args)`` of one corpus lie apart."""
    return {"objective_rel": abs(a[0].last_objective_ / b[0].last_objective_ - 1),
            "state_abs": float(numpy.abs(a[0].state - b[0].state).max()),
            "trans_abs": float(numpy.abs(a[0].trans - b[0].trans).max()),
            "probability_abs": float(numpy.abs(a[1] - b[1]).max())}


def same_function(card, cpu):
    """The objective and gradient on the card and on the CPU at the same
    points, zero and the card fit's last: the objective within
    ``EVALUATION_RTOL`` relative, the gradient at zero within
    ``EVALUATION_RTOL`` of its largest magnitude (at the optimum it is a
    difference of large sums, and only its objective is held)."""
    from gecco_tpu_torch.crf import train

    x_last, idx_card, y_card, c2 = card[2]
    _, idx_cpu, y_cpu, _ = cpu[2]
    require(torch.equal(idx_card.cpu(), idx_cpu) and torch.equal(y_card.cpu(), y_cpu),
            "8b: the card's and the CPU's index tensors differ")
    gaps = {}
    for name, x in (("zero", numpy.zeros_like(x_last)), ("last", x_last)):
        f_card, g_card = train._value_and_grad(x, idx_card, y_card, c2)
        f_cpu, g_cpu = train._value_and_grad(x, idx_cpu, y_cpu, c2)
        gaps[f"objective_rel_{name}"] = abs(f_card / f_cpu - 1)
        gaps[f"gradient_rel_{name}"] = float(numpy.abs(g_card - g_cpu).max()
                                             / numpy.abs(g_cpu).max())
    print(f"# 8b objective and gradient, card against CPU at the same points: "
          f"{json.dumps(gaps)} (bound {EVALUATION_RTOL})", flush=True)
    require(gaps["objective_rel_zero"] <= EVALUATION_RTOL
            and gaps["objective_rel_last"] <= EVALUATION_RTOL
            and gaps["gradient_rel_zero"] <= EVALUATION_RTOL,
            f"8b: the card's objective differs from the CPU's: {gaps}")


def write_training_tables(genes, directory):
    """``genes`` as the genes, features and clusters tables of ``train``
    and ``cv`` (a cluster row for each run of labelled genes)."""
    from gecco_tpu_torch.model import ClusterTable, FeatureTable, GeneTable

    with open(os.path.join(directory, "genes.tsv"), "wb") as f:
        GeneTable.from_genes(genes).dump(f)
    with open(os.path.join(directory, "features.tsv"), "wb") as f:
        FeatureTable.from_genes(genes).dump(f)
    rows = {key: [] for key in ("sequence_id", "cluster_id", "start", "end", "average_p",
                                "max_p", "type", "proteins", "domains")}
    run = []
    for gene, following in zip(genes, genes[1:] + [None]):
        if gene.average_probability == 1.0:
            run.append(gene)
        if run and (following is None or following.source.id != gene.source.id
                    or following.average_probability != 1.0):
            rows["sequence_id"].append(gene.source.id)
            rows["cluster_id"].append(f"{gene.source.id}_cluster_{len(rows['start']) + 1}")
            rows["start"].append(run[0].start)
            rows["end"].append(run[-1].end)
            rows["average_p"].append(1.0)
            rows["max_p"].append(1.0)
            rows["type"].append("Polyketide")
            rows["proteins"].append(";".join(g.protein.id for g in run))
            rows["domains"].append("")
            run = []
    with open(os.path.join(directory, "clusters.tsv"), "wb") as f:
        ClusterTable(rows).dump(f)


def phase_train_cli(device, state, cut_corpus):
    """8c: ``annotate``, ``predict``, ``train``, ``predict --model``, ``cv``
    and ``convert`` on the card, from phase 7's genome, bank and output."""
    from gecco_tpu_torch.cli import main

    tmp = state["workdir"]

    def cli(name, argv):
        t0 = time.perf_counter()
        code = main([str(a) for a in argv])
        print(f"# 8c {name}: exit {code} in {time.perf_counter() - t0:.3f} s", flush=True)
        require(code == 0, f"gecco-tpu-torch {name} exited {code}")

    def text(*parts):
        with open(os.path.join(*parts)) as f:
            return f.read()

    dev = ["--device", device.type]
    annotated = os.path.join(tmp, "annotate")
    TIMER.reset()
    cli("annotate", ["annotate", "-g", state["genome_path"], "--hmm", state["bank_path"],
                     "-o", annotated, *dev])
    launches = launch_counts()
    print(f"# 8c annotate launches {json.dumps(launches)}", flush=True)
    for name in DEFAULT_PATH:
        require(launches[name] > 0, f"annotate did not launch kernel {name}")
    tables = ["-g", os.path.join(annotated, "genome.genes.tsv"),
              "-f", os.path.join(annotated, "genome.features.tsv")]
    predicted = os.path.join(tmp, "predict")
    cli("predict", ["predict", "--genome", state["genome_path"], *tables, "-o", predicted,
                    "--force-tsv", *dev])
    require(text(predicted, "genome.clusters.tsv") == text(state["run_dir"], "genome.clusters.tsv"),
            "predict from annotate's tables does not give run's clusters table")
    run_tables = ["-g", os.path.join(state["run_dir"], "genome.genes.tsv"),
                  "-f", os.path.join(state["run_dir"], "genome.features.tsv"),
                  "-c", os.path.join(state["run_dir"], "genome.clusters.tsv")]
    model = os.path.join(tmp, "model")
    cli("train", ["train", *run_tables, "-o", model, *dev])
    files = sorted(os.listdir(model))
    print(f"# 8c model files: {files}", flush=True)
    for name in ("crf_model.npz", "crf_model.npz.sha256", "model.trans.tsv",
                 "model.state.tsv", "domains.tsv", "types.tsv", "compositions.npz"):
        require(name in files, f"train wrote no {name}")
    cli("predict --model", ["predict", "--genome", state["genome_path"], *tables,
                            "-o", os.path.join(tmp, "predict_model"), "--model", model,
                            "--force-tsv", *dev])
    corpus_dir = os.path.join(tmp, "corpus")
    os.makedirs(corpus_dir)
    write_training_tables(cut_corpus, corpus_dir)
    cv_table = os.path.join(tmp, "cv.tsv")
    cli("cv", ["cv", "-g", os.path.join(corpus_dir, "genes.tsv"),
               "-f", os.path.join(corpus_dir, "features.tsv"),
               "-c", os.path.join(corpus_dir, "clusters.tsv"), "-o", cv_table,
               "--splits", "3", *dev])
    from gecco_tpu_torch.crf.metrics import roc_auc_score

    rows = [row.split("\t") for row in text(cv_table).splitlines()]
    require(len(rows) == len(cut_corpus) + 1, f"cv wrote {len(rows) - 1} of {len(cut_corpus)} genes")
    label, probability = rows[0].index("is_cluster"), rows[0].index("average_p")
    auroc = roc_auc_score([row[label] == "true" for row in rows[1:]],
                          [float(row[probability]) for row in rows[1:]])
    print(f"# 8c cv: AUROC {auroc!r} over the {len(rows) - 1} genes of its folds", flush=True)
    require(auroc > 0.9, f"cv's folds predict their clusters with an AUROC of {auroc}")
    converted = os.path.join(tmp, "convert")
    cli("convert gbk", ["convert", "gbk", "-i", state["run_dir"], "-o", converted, "-f", "faa"])
    cli("convert clusters", ["convert", "clusters", "-i", state["run_dir"], "-o", converted,
                             "-f", "gff"])
    written = sorted(os.listdir(converted))
    require(any(n.endswith(".faa") for n in written) and "genome.clusters.gff" in written,
            f"convert wrote {written}")


# --- phase 9: the modules around the kernels --------------------------------------

@contextlib.contextmanager
def sub_phase(name, traced=True):
    """Sub-phase ``9<name>``: prints its wall seconds and the device ms the
    profiler recorded in it (:func:`device_trace`, after its lead); without
    ``traced`` (a body that opens its own trace) the caller reports the
    device ms through the yielded dict's ``device_ms``."""
    out = {}
    print(f"# phase 9{name}: start", flush=True)
    trace = device_trace() if traced else contextlib.nullcontext()
    t_open = time.perf_counter()
    with trace as prof:
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(device_ms(prof).values()) if traced else out.get("device_ms")
    print(f"# phase 9{name}: {wall:.3f} s wall, {busy!r} device ms (with the trace's opening, "
          f"lead and reading {time.perf_counter() - t_open:.3f} s)", flush=True)


def gate_values(pipeline, gm, x, Z, domZ):
    """The float64 host path's gate values of one pair, each beside its
    threshold: the bias-filtered F3 P-value, the E-value and the best
    domain's i-Evalue."""
    from gecco_tpu_torch.hmm import engine
    from gecco_tpu_torch.hmm.bank import ProfileBank, bias_logratio
    from gecco_tpu_torch.hmm.profile import null1_score

    ln2 = math.log(2.0)
    fwd = engine.forward(gm, x)
    bits = (fwd.score - null1_score(len(x))) / ln2
    tau, lam = gm.hmm.stats["FORWARD"]
    counts = numpy.bincount(numpy.minimum(x, 20), minlength=21)[:20].astype(numpy.float64)
    delta = float(counts @ bias_logratio(ProfileBank.build([gm])).astype(numpy.float64)[:, 0])
    extra = max(numpy.logaddexp(0.0, delta) - ln2, 0.0) / ln2
    gates = {"F3": (engine.exp_surv(bits - extra, tau, lam), pipeline.F3),
             "E": (engine.exp_surv(bits, tau, lam) * Z, pipeline.E)}
    domains = engine.define_domains(gm, x, fwd)
    if domains:
        gates["domE"] = (min(d.pvalue for d in domains) * domZ, pipeline.domE)
    return gates


def phase_host_path(device, state):
    """9b: ``use_accelerator=False`` against the kernels on a cut of phase 3."""
    from gecco_tpu_torch.hmm.pipeline import SearchPipeline

    seqs = state["seqs"][:HOST_PROTEINS]
    profiles = [state["profiles"][(13 * i) % N_PROFILES] for i in range(HOST_PROFILES)]
    cuda = SearchPipeline(profiles, device=device, Z=N_PROFILES, domZ=N_PROFILES,
                          backend="cuda")
    cuda_hits = cuda.search(seqs)
    host = SearchPipeline(profiles, device=device, Z=N_PROFILES, domZ=N_PROFILES,
                          use_accelerator=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    before = (launch_counts(), torch.cuda.memory_allocated(device))
    t0 = time.perf_counter()
    host_hits = host.search(seqs)
    seconds = time.perf_counter() - t0
    require(launch_counts() == before[0], "the host path launched a kernel")
    require(torch.cuda.max_memory_allocated(device) == before[1],
            "the host path allocated device memory")
    pairs = len(seqs) * len(profiles)
    print(f"# 9b host path: {len(seqs)} proteins x {len(profiles)} profiles, {seconds:.3f} s, "
          f"{seconds / pairs!r} s a pair; stage_counts {json.dumps(host.stage_counts)}; "
          f"kernels' stage_counts {json.dumps(cuda.stage_counts)}", flush=True)
    by_key = {(h.sequence_index, h.profile.name): h for h in host_hits}
    missing = [h for h in cuda_hits if (h.sequence_index, h.profile.name) not in by_key]
    for h in missing:
        gates = gate_values(host, h.profile, seqs[h.sequence_index], N_PROFILES, N_PROFILES)
        near = {k: abs(v / t - 1.0) <= 1e-3 for k, (v, t) in gates.items()}
        print(f"# 9b kernel hit {(h.sequence_index, h.profile.name)} not reported by the host "
              f"path; float64 gate values (value, threshold): {json.dumps(gates)}", flush=True)
        require(any(near.values()), f"9b: kernel hit {(h.sequence_index, h.profile.name)} "
                                    f"is no host hit and no gate value is near its threshold")
    worst, moved = 0.0, 0
    for h in cuda_hits:
        other = by_key.get((h.sequence_index, h.profile.name))
        if other is None:
            continue
        worst = max(worst, abs(h.score - other.score))
        moved += sum(
            (a.ienv, a.jenv, a.target_from, a.target_to, a.hmm_from, a.hmm_to)
            != (b.ienv, b.jenv, b.target_from, b.target_to, b.hmm_from, b.hmm_to)
            for a, b in zip(h.domains, other.domains)) + abs(len(h.domains) - len(other.domains))
    print(f"# 9b {len(cuda_hits)} kernel hits, {len(host_hits)} host hits "
          f"({len(host_hits) - len(cuda_hits) + len(missing)} beyond the kernels' filters, "
          f"{len(missing)} kernel hits near a gate); common hits' scores within {worst!r} bits; "
          f"{moved} domains whose coordinates differ", flush=True)
    require(cuda_hits and worst <= 5e-3, f"9b: scores differ by {worst} bits")


def phase_sharded_search(device, state):
    """9c: phase 3's search over two slots of the card, and pinned to it."""
    from gecco_tpu_torch.hmm.pipeline import SearchPipeline
    from gecco_tpu_torch.parallel import shard_sequences

    profiles, seqs = state["profiles"], state["seqs"]
    options = dict(device=device, Z=N_PROFILES, domZ=N_PROFILES, backend="cuda")
    alone = {}
    for shard in shard_sequences(seqs, 2):
        pipeline = SearchPipeline(profiles, **options)
        _ = pipeline.bank
        TIMER.reset()
        pipeline.search([seqs[i] for i in shard])
        for name, count in launch_counts().items():
            alone[name] = alone.get(name, 0) + count
    multi = SearchPipeline(profiles, devices=[device, device], **options)
    multi.search(seqs)  # uploads each shard's bank
    torch.cuda.synchronize()
    TIMER.reset()
    t0 = time.perf_counter()
    hits = multi.search(seqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    print(f"# 9c sharded search (two slots of {device}): {seconds:.3f} s against phase 3's "
          f"{state['search_s']:.3f} s; stage_devices {multi.stage_devices}; stage spans (s) "
          f"{json.dumps(stage_span_seconds())}; launches {json.dumps(launches)}, the two shards "
          f"alone {json.dumps(alone)}", flush=True)
    require(multi.stage_devices == 2, f"stage_devices {multi.stage_devices}")
    require(launches == alone, "the sharded search's launches differ from its shards' alone")
    require(multi.stage_counts == state["search_counts"],
            f"sharded funnel {multi.stage_counts} != phase 3's {state['search_counts']}")
    same_hits(hits, state["search_hits"], "9c sharded")
    pinned = SearchPipeline(profiles, devices=[device], **options)
    same_hits(pinned.search(seqs), state["search_hits"], "9c pinned")
    require(pinned.stage_devices == 1 and pinned.stage_counts == state["search_counts"],
            f"pinned funnel {pinned.stage_counts}")
    print(f"# 9c pinned to [{device}]: phase 3's {len(hits)} hits", flush=True)


def same_hits(hits, records, label):
    """``hits`` against :func:`hit_record`s: the same hits in the same order,
    scores within 1e-4 bits, domain coordinates equal, domain bits 1e-2."""
    got = [hit_record(h) for h in hits]
    require([r[:2] for r in got] == [r[:2] for r in records], f"{label}: hits differ")
    for a, b in zip(got, records):
        require(abs(a[2] - b[2]) <= 1e-4, f"{label}: score {a[:3]} != {b[2]}")
        require(a[3] == b[3], f"{label}: domain coordinates of {a[:2]} differ")
        require(all(abs(x - y) <= 1e-2 for x, y in zip(a[4], b[4])),
                f"{label}: domain bits of {a[:2]} differ")


def card_mesh(device, data, model):
    """A ``(data, model)`` mesh whose every slot is ``device``."""
    from gecco_tpu_torch.parallel import Mesh

    grid = numpy.empty(data * model, dtype=object)
    grid[:] = [device] * (data * model)
    return Mesh(grid.reshape(data, model))


def phase_sharded_scores(device, state):
    """9d: ``sharded_forward_scores`` on a 2 x 2 mesh of the card."""
    from gecco_tpu_torch.hmm.kernels import SeqPack, dense_scores
    from gecco_tpu_torch.parallel import sharded_forward_scores

    bank, seqs = state["bank"], state["seqs"][:DENSE_PROTEINS]
    pack = SeqPack(seqs, device)
    for semiring in ("forward", "viterbi"):
        viterbi = semiring == "viterbi"
        t0 = time.perf_counter()
        got = sharded_forward_scores(bank.host, seqs, card_mesh(device, 2, 2), viterbi=viterbi)
        seconds = time.perf_counter() - t0
        want = dense_scores(pack, bank, viterbi=viterbi).cpu().numpy()
        finite = numpy.isfinite(want)
        require(numpy.array_equal(numpy.isfinite(got), finite), f"9d {semiring}: infinities")
        err = float(numpy.abs(got[finite] - want[finite]).max())
        print(f"# 9d sharded_forward_scores ({semiring}, 2 x 2 slots of {device}, "
              f"{len(seqs)} proteins x {bank.P} profiles): {seconds:.3f} s, max abs {err!r} "
              f"nats from one dense_scores call (tol 1e-4)", flush=True)
        require(err <= 1e-4, f"9d {semiring}: {err} nats from one dense_scores call")


def phase_train_step(device, state):
    """9e: ``crf_train_step`` on a 2-slot data mesh of the card over 8a's
    windows, against the 1-slot step."""
    from gecco_tpu_torch.parallel import crf_train_step

    idx, y, A = state["windows"]
    results = {}
    for slots in (1, 2):
        step, params = crf_train_step(card_mesh(device, slots, 1))(A)
        t0 = time.perf_counter()
        params, loss = step(params, idx, y, TRAIN_STEP_LR)
        torch.cuda.synchronize()
        results[slots] = (params, float(loss), time.perf_counter() - t0)
    (one, loss_one, s_one), (two, loss_two, s_two) = results[1], results[2]
    rel = abs(loss_two - loss_one) / abs(loss_one)
    err = max(float((a - b).abs().max()) for a, b in zip(one, two))
    print(f"# 9e crf_train_step over {idx.shape[0]} windows (vocabulary {A}, lr "
          f"{TRAIN_STEP_LR}): 1 slot loss {loss_one!r} in {s_one:.3f} s, 2 slots {loss_two!r} "
          f"in {s_two:.3f} s; loss {rel!r} relative, parameters {err!r} absolute apart",
          flush=True)
    require(numpy.isfinite(loss_one) and rel <= 1e-5 and err <= 1e-5,
            f"9e: the 2-slot step differs from the 1-slot step ({rel}, {err})")


def phase_cli_options(device, state, out):
    """9f: ``run --profile DIR`` and ``run --devices 1`` on phase 7's genome."""
    from gecco_tpu_torch.cli import main

    tmp = state["workdir"]

    def text(*parts):
        with open(os.path.join(*parts)) as f:
            return f.read()

    def run(name, extra):
        target = os.path.join(tmp, name)
        t0 = time.perf_counter()
        code = main(["run", "-g", state["genome_path"], "--hmm", state["bank_path"], "-o",
                     target, "--device", device.type, "--force-tsv", *extra])
        print(f"# 9f run {' '.join(extra)}: exit {code} in {time.perf_counter() - t0:.3f} s",
              flush=True)
        require(code == 0, f"run {extra} exited {code}")
        return target

    traces = os.path.join(tmp, "trace")
    profiled = run("profiled", ["--profile", traces])
    found = [f for f in os.listdir(traces) if f.endswith(".pt.trace.json")]
    require(len(found) == 1, f"run --profile wrote {found}")
    with open(os.path.join(traces, found[0])) as f:
        trace = json.load(f)
    kernels = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    names = {e.get("name", "") for e in kernels}
    out["device_ms"] = sum(float(e.get("dur", 0.0)) for e in kernels) / 1e3
    print(f"# 9f trace {found[0]}: {os.path.getsize(os.path.join(traces, found[0]))} bytes, "
          f"{len(kernels)} kernel launches, {len(names)} kernel names, kernel A's "
          f"{sum('ssv_kernel' in n for n in names)}", flush=True)
    require(any("ssv_kernel" in n for n in names), "the trace names no ssv_kernel")
    require(text(profiled, "genome.clusters.tsv") == text(state["run_dir"], "genome.clusters.tsv"),
            "run --profile gives another clusters table than phase 7's")
    stray = [os.path.join(folder, f) for folder, _dirs, files in os.walk(tmp) for f in files
             if f.endswith(".pt.trace.json") and folder != traces]
    require(not stray, f"a run without --profile wrote a trace: {stray}")
    one = run("devices1", ["--devices", "1"])
    for kind in ("genes", "features", "clusters"):
        require(text(one, f"genome.{kind}.tsv") == text(state["run_dir"], f"genome.{kind}.tsv"),
                f"run --devices 1 gives another {kind} table than phase 7's")


def phase_modules(device, state):
    import importlib.util

    with sub_phase("a torch_check"):
        spec = importlib.util.spec_from_file_location(
            "torch_check", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                                        "torch_check.py"))
        check = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(check)
        check.run(device)
    with sub_phase("b host path"):
        phase_host_path(device, state)
    with sub_phase("c sharded search"):
        phase_sharded_search(device, state)
    with sub_phase("d sharded scores"):
        phase_sharded_scores(device, state)
    with sub_phase("e train step"):
        phase_train_step(device, state)
    with sub_phase("f cli", traced=False) as out:
        phase_cli_options(device, state, out)


def make_report(kernels):
    """The ``report`` that each kernel check calls, writing into ``kernels``."""

    def report(name, checks, ms, plain_ms, work, variant=None, **extra):
        """Hold a kernel's outputs against its plain version's: ``checks`` are
        ``(tolerance key, got, want)``.  ``max_abs_err`` covers the outputs
        held to an absolute tolerance; the bfloat16 planes are held to
        ``|got - want| <= 1e-30 + PLANE_RTOL |want|`` and give ``max_rel_err``.
        ``work`` is the ``(flops, bytes)`` of the timed launches, whose bound
        goes beside ``ms``; no single PyTorch call computes these
        recurrences, so ``library_ms`` is null.  A ``variant`` (another bank
        for the same kernel) goes under the kernel's ``variants``."""
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
        label = name if variant is None else f"{name} ({variant} bank)"
        print(f"# kernel {label}: {json.dumps(entry)} (abs tol {tols}"
              + (f", planes rel tol {PLANE_RTOL}" if "max_rel_err" in entry else "")
              + f"; {work[0]!r} flops, {work[1]!r} bytes)", flush=True)
        if variant is None:
            kernels[name] = entry
        else:
            kernels.setdefault(name, {}).setdefault("variants", {})[variant] = entry

    return report


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    device = torch.device("cuda:0")
    kernels = {}
    state = {}
    report = make_report(kernels)

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
        phase_registers()
    with Phase("2 kernels"):
        phase_kernels(device, report, kernels)
    with Phase("3 search"):
        phase_search(device, state)
    with Phase("4 max-filter search"):
        phase_max_filter(device, state)
    with Phase("5 msv search"):
        phase_msv_search(device, state)
    with Phase("6 pair domains"):
        phase_pair_domains(device, state)
    with tempfile.TemporaryDirectory() as workdir:
        state["workdir"] = workdir
        with Phase("7 cli"):
            phase_cli(device, state)
        with Phase("8 train"):
            phase_train(device, state)
        with Phase("9 modules"):
            phase_modules(device, state)

    loaded = sorted(name for name, module in sys.modules.items()
                    if module is not None and name.split(".")[0] in ("jax", "gecco_tpu"))
    require(not loaded, f"JAX or the JAX package was imported: {loaded}")
    # each kernel's launches on the search whose path it is
    launches = {**state["launches"], "dense_scores": state["max_launches"]["dense_scores"],
                "msv_filter": state["msv_launches"]["msv_filter"],
                **{name: state["pair_launches"][name] for name in PAIR_PATH}}
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
