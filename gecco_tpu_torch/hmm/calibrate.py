"""hmmbuild-style E-value calibration, scored with the port's kernels.

The fit of ``gecco_tpu.hmm.calibrate.calibrate`` (fixed ``lambda = log
2``, Gumbel location MLE for MSV and Viterbi, exponential tail anchored
at the ``tailp`` quantile for Forward), with the three scores of every
(random sequence, profile) pair taken from kernels A, B and C in
all-pairs mode (their plain versions for a bank on the CPU).
"""

import math
from typing import List, Sequence

import numpy

from .._device import resolve_device
from .bank import TorchBank
from .io import BACKGROUND_F
from .kernels import SeqPack, ssv_filter, viterbi_pairs
from .profile import SearchProfile, null1_score
from .stream import forward_pairs

__all__ = ["calibrate"]

LOG2 = math.log(2.0)


def calibrate(
    profiles: Sequence[SearchProfile],
    *,
    device,
    n: int = 256,
    L: int = 256,
    seed: int = 0,
    tailp: float = 0.04,
) -> List[SearchProfile]:
    """Fit MSV/VITERBI/FORWARD stats in place; returns ``profiles``.

    ``n`` random background sequences of length ``L`` (the same draws
    as the JAX package's ``calibrate`` for the same ``seed``) are scored
    against every profile.  Rebuild any bank afterwards.
    """
    profiles = list(profiles)
    if not profiles:
        return profiles
    device = resolve_device(device)
    rng = numpy.random.default_rng(seed)
    p_bg = BACKGROUND_F / BACKGROUND_F.sum()
    seqs = [
        rng.choice(20, size=L, p=p_bg).astype(numpy.int32) for _ in range(n)
    ]
    bank = TorchBank.build(profiles, device)
    pack = SeqPack(seqs, device)
    P = len(profiles)
    s_idx = numpy.repeat(numpy.arange(n, dtype=numpy.int64), P)
    p_idx = numpy.tile(numpy.arange(P, dtype=numpy.int64), n)
    ssv_sc = ssv_filter(pack, bank).cpu().numpy()
    vit = viterbi_pairs(pack, bank, s_idx, p_idx).cpu().numpy().reshape(n, P)
    fwd = forward_pairs(pack, bank, s_idx, p_idx).cpu().numpy().reshape(n, P)
    null = null1_score(L)
    bits_ssv = (ssv_sc.astype(numpy.float64) - null) / LOG2   # [n, P]
    bits_vit = (vit.astype(numpy.float64) - null) / LOG2
    bits_fwd = (fwd.astype(numpy.float64) - null) / LOG2
    lam = LOG2
    mu = -numpy.log(numpy.mean(numpy.exp(-lam * bits_ssv), axis=0)) / lam
    vmu = -numpy.log(numpy.mean(numpy.exp(-lam * bits_vit), axis=0)) / lam
    t_tail = numpy.quantile(bits_fwd, 1.0 - tailp, axis=0)
    tau = t_tail + math.log(tailp) / lam
    for p, gm in enumerate(profiles):
        gm.hmm.stats["MSV"] = (float(mu[p]), lam)
        gm.hmm.stats["VITERBI"] = (float(vmu[p]), lam)
        gm.hmm.stats["FORWARD"] = (float(tau[p]), lam)
    return profiles
