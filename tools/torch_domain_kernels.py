#!/usr/bin/env python3
"""Time kernels D and F of the PyTorch port alone, per width class.

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

Each launch is prepared beforehand (``hmm.stream.posterior_fwd_launches``,
``align_bwd_launches``) and timed alone between CUDA events: the mean of
5 (clustered) or 2 (dense) launches after a warm-up.  Prints the card's
name and power limit, then one JSON line a tree.
"""

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

    rng = numpy.random.default_rng(0)
    ms = {}
    for width in CLASSES:
        members = numpy.flatnonzero(bank.class_of == width)
        for case, n, profiles, repeats in (("clustered", 400, members[:25], 5),
                                            ("dense", 3000, members, 2)):
            s_idx = rng.integers(0, len(seqs), n)
            p_idx = rng.choice(profiles, n)
            for name, prepare in (("D", stream.posterior_fwd_launches),
                                  ("F", stream.align_bwd_launches)):
                launches, out = prepare(pack, bank, s_idx, p_idx)
                (launch,) = launches.values()
                ms[f"{name} {case} {width}"] = timed(launch, repeats)
                del launches, out
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
