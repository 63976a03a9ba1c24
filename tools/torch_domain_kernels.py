#!/usr/bin/env python3
"""Time kernels D-G of the PyTorch port alone, per width class.

Run from the root of a checkout, on a machine with one NVIDIA GPU::

    python3 tools/torch_domain_kernels.py [TREE ...]

Each TREE (by default this checkout) is a directory that holds a
``gecco_tpu_torch`` package: a variant of the kernels to compare.  Each
is timed in a process of its own, in the order given, so that variants
take turns on the same card (``A B B A``).  For each width class of 128
to 1,024 nodes of 2,766 Pfam-shaped profiles, two sets of rows against
3,000 synthetic proteins cut to 512 residues:

* ``clustered``: 400 rows over 25 profiles of the class, many rows a
  profile, a launch as short as the default search's (latency);
* ``dense``: 3,000 rows over every profile of the class, as the
  ``max_filter`` search's launches (throughput).

Kernel E takes kernel D's outputs for the same rows; kernel G takes
kernel F's planes and one envelope a row, the first that
``hmm.stream.envelopes`` finds from E's posteriors (the whole sequence
where it finds none).  Each launch is prepared beforehand
(``hmm.stream.posterior_fwd_launches`` and the like) and timed alone
between CUDA events: the mean of 5 (clustered) or 2 (dense) launches
after a warm-up.  A tree whose ``hmm.stream`` has no prepared launches
for E or G (before they took a block schedule) launches them through
``_Rows.launch``, set up beforehand in the same way.  Prints the card's
name and power limit, then one JSON line a tree.
"""

import functools
import json
import os
import subprocess
import sys
import warnings

CLASSES = (128, 256, 512, 1024)
N_PROFILES = 2766
N_PROTEINS = 3000


def time_tree(tree):
    """One JSON line of device ms per kernel, row set and width class."""
    sys.path.insert(0, tree)
    sys.modules["jax"] = None
    import numpy
    import torch

    from gecco_tpu_torch import _build
    from gecco_tpu_torch.hmm import stream
    from gecco_tpu_torch.hmm.bank import TorchBank
    from gecco_tpu_torch.hmm.kernels import SeqPack
    from gecco_tpu_torch.hmm.synthetic import pfam_shaped_profiles, synthetic_proteins

    if not stream.__file__.startswith(tree):
        raise RuntimeError(f"imported {stream.__file__}, not the package of {tree}")
    _build.library()
    device = torch.device("cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bank = TorchBank.build(pfam_shaped_profiles(N_PROFILES, seed=0), device)
    seqs = [x[:512] for x in synthetic_proteins(N_PROTEINS, mean_length=280, seed=3)]
    pack = SeqPack(seqs, device)

    def timed(fn, repeats):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / repeats

    def one_launch(launches, out):
        (launch,) = launches.values()
        return launch, out

    def posterior_bwd(s_idx, p_idx, traj, score):
        if hasattr(stream, "posterior_bwd_launches"):
            return one_launch(*stream.posterior_bwd_launches(pack, bank, s_idx, p_idx, traj,
                                                             score))
        rows = stream._Rows(pack, bank, s_idx, p_idx)
        post = torch.empty((2, rows.n, rows.stride), dtype=torch.float32, device=device)
        return functools.partial(rows.launch, "gecco_posterior_bwd", "posterior_bwd", traj,
                                 score, post), post

    def align_fwd(s_idx, p_idx, planes, logs, iv, jv, total):
        if hasattr(stream, "align_fwd_launches"):
            return one_launch(*stream.align_fwd_launches(pack, bank, s_idx, p_idx, planes, logs,
                                                         iv, jv, total))
        rows = stream._Rows(pack, bank, s_idx, p_idx)
        out = torch.empty((rows.n, 22), dtype=torch.float32, device=device)
        coords = torch.empty((rows.n, 4), dtype=torch.int32, device=device)
        env = [torch.as_tensor(a.astype(numpy.int32), device=device) for a in (iv, jv)]
        return functools.partial(rows.launch, "gecco_align_fwd", "align_fwd", planes, logs,
                                 *env, total, out, coords), (out, coords)

    def first_envelopes(s_idx, post):
        """Each row's first envelope slot, else its whole sequence (host)."""
        lens = pack.lens[torch.as_tensor(s_idx, device=device)]
        env_i, env_j, _over = stream.envelopes(post[0], post[1], lens)
        ok = env_j >= env_i
        first = torch.argmax(ok.int(), dim=1, keepdim=True)
        has = ok.any(dim=1)
        iv = torch.where(has, env_i.gather(1, first)[:, 0], 1)
        jv = torch.where(has, env_j.gather(1, first)[:, 0], lens)
        return iv.cpu().numpy(), jv.cpu().numpy()

    rng = numpy.random.default_rng(0)
    ms = {}
    for width in CLASSES:
        members = numpy.flatnonzero(bank.class_of == width)
        for case, n, profiles, repeats in (("clustered", 400, members[:25], 5),
                                            ("dense", 3000, members, 2)):
            s_idx = rng.integers(0, len(seqs), n)
            p_idx = rng.choice(profiles, n)
            launch, (traj, score) = one_launch(*stream.posterior_fwd_launches(pack, bank, s_idx,
                                                                              p_idx))
            ms[f"D {case} {width}"] = timed(launch, repeats)
            launch, post = posterior_bwd(s_idx, p_idx, traj, score)
            ms[f"E {case} {width}"] = timed(launch, repeats)
            iv, jv = first_envelopes(s_idx, post)
            launch, (planes, logs) = one_launch(*stream.align_bwd_launches(pack, bank, s_idx,
                                                                           p_idx))
            ms[f"F {case} {width}"] = timed(launch, repeats)
            launch, _out = align_fwd(s_idx, p_idx, planes, logs, iv, jv, score)
            ms[f"G {case} {width}"] = timed(launch, repeats)
            del launch, traj, score, post, planes, logs, _out
            torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, "ms": ms}), flush=True)


def main(argv):
    if argv[:1] == ["--one"]:
        time_tree(os.path.abspath(argv[1]))
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for tree in argv or [here]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree], check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
