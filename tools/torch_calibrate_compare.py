#!/usr/bin/env python3
"""Compare ``calibrate``'s two ways of scoring on the card, and their funnels.

Run from the root of a checkout, on a machine with one NVIDIA GPU::

    python3 tools/torch_calibrate_compare.py [--device cuda] [--genes 3230] [--profiles 2766]

``gecco_tpu_torch.hmm.calibrate`` scores every (background sequence,
profile) pair on kernel A (SSV) and kernel H (dense Viterbi and Forward),
as the JAX package's Pallas branch does.  Before, it listed the pairs for
kernels B (Viterbi) and C (Forward).  On the profiles of
``hmm.synthetic.bench_workload`` this tool times both, in turns (earlier,
current, current, earlier), prints how far each fitted statistic moved
(bits), and the survivor funnel (``stage_counts``) of the default, MSV
and ``max_filter`` searches under the current statistics and of the
default search under the earlier ones.  Prints the card's name and power
limit first.  With ``--device cpu`` (small ``--genes`` and
``--profiles``) every kernel takes its plain version.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy
import torch

LOG2 = math.log(2.0)
KEYS = ("MSV", "VITERBI", "FORWARD")


def earlier_calibrate(profiles, device, n=256, L=256, seed=0, tailp=0.04):
    """The statistics as ``calibrate`` fitted them from kernels A, B and C."""
    from gecco_tpu_torch.hmm.bank import TorchBank
    from gecco_tpu_torch.hmm.calibrate import background_sequences
    from gecco_tpu_torch.hmm.kernels import SeqPack, ssv_filter, viterbi_pairs
    from gecco_tpu_torch.hmm.profile import null1_score
    from gecco_tpu_torch.hmm.stream import forward_pairs

    bank = TorchBank.build(profiles, device)
    pack = SeqPack(background_sequences(n, L, seed), device)
    P = len(profiles)
    s_idx = numpy.repeat(numpy.arange(n, dtype=numpy.int64), P)
    p_idx = numpy.tile(numpy.arange(P, dtype=numpy.int64), n)
    null = null1_score(L)
    ssv = (ssv_filter(pack, bank).cpu().numpy().astype(numpy.float64) - null) / LOG2
    vit = (viterbi_pairs(pack, bank, s_idx, p_idx).cpu().numpy().reshape(n, P)
           .astype(numpy.float64) - null) / LOG2
    fwd = (forward_pairs(pack, bank, s_idx, p_idx).cpu().numpy().reshape(n, P)
           .astype(numpy.float64) - null) / LOG2
    mu = -numpy.log(numpy.mean(numpy.exp(-LOG2 * ssv), axis=0)) / LOG2
    vmu = -numpy.log(numpy.mean(numpy.exp(-LOG2 * vit), axis=0)) / LOG2
    tau = numpy.quantile(fwd, 1.0 - tailp, axis=0) + math.log(tailp) / LOG2
    return {"MSV": mu, "VITERBI": vmu, "FORWARD": tau}


def main(argv=None):
    from gecco_tpu_torch._device import resolve_device
    from gecco_tpu_torch.hmm.calibrate import calibrate
    from gecco_tpu_torch.hmm.pipeline import SearchPipeline
    from gecco_tpu_torch.hmm.synthetic import bench_workload

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--genes", type=int, default=3230)
    parser.add_argument("--profiles", type=int, default=2766)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
    _genome, profiles, seqs = bench_workload(args.genes, args.profiles)
    seconds = {"earlier": [], "current": []}
    for kind in ("earlier", "current", "current", "earlier"):
        sync()
        t0 = time.perf_counter()
        if kind == "earlier":
            earlier = earlier_calibrate(profiles, device)
        else:
            calibrate(profiles, device=device)
        sync()
        seconds[kind].append(time.perf_counter() - t0)
    print(f"# calibrate seconds, in turns: {json.dumps(seconds)}", flush=True)
    current = {key: numpy.array([gm.hmm.stats[key][0] for gm in profiles]) for key in KEYS}
    for key in KEYS:
        moved = numpy.abs(current[key] - earlier[key])
        print(f"# {key} location: largest move {float(moved.max())!r} bits, mean "
              f"{float(moved.mean())!r}, {int((moved > 0).sum())} of {len(profiles)} "
              f"profiles moved", flush=True)

    def funnel(label, **options):
        pipeline = SearchPipeline(profiles, device=device, Z=args.profiles,
                                  domZ=args.profiles, **options)
        sync()
        t0 = time.perf_counter()
        hits = pipeline.search(seqs)
        sync()
        print(f"# {label}: {time.perf_counter() - t0:.3f} s, stage_counts "
              f"{json.dumps(pipeline.stage_counts)}, "
              f"{sum(len(h.domains) for h in hits)} domains", flush=True)

    funnel("default search")
    funnel("MSV search", filter_stage="msv")
    funnel("max_filter search", max_filter=True)
    for p, gm in enumerate(profiles):
        for key in KEYS:
            gm.hmm.stats[key] = (float(earlier[key][p]), LOG2)
    funnel("default search, earlier statistics")
    return 0


if __name__ == "__main__":
    sys.exit(main())
