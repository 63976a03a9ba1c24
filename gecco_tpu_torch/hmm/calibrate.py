"""hmmbuild-style E-value calibration, scored with the port's kernels.

The fit of ``gecco_tpu.hmm.calibrate.calibrate`` (fixed ``lambda = log
2``, Gumbel location MLE for MSV and Viterbi, exponential tail anchored
at the ``tailp`` quantile for Forward), with the three scores of every
(random sequence, profile) pair taken as the JAX package's Pallas branch
takes them: the SSV scores from kernel A, the Viterbi and Forward scores
from the dense all-pairs kernel H in its two semirings
(:func:`~.kernels.dense_scores`, JAX's ``ViterbiKernel`` and
``ForwardKernel``).  ``backend="auto"`` takes the kernels on a card and
their plain versions on the CPU; ``"torch"`` takes the plain versions.
"""

import math
from typing import List, Sequence

import numpy

from .._device import resolve_backend, resolve_device
from .bank import TorchBank
from .io import BACKGROUND_F
from .kernels import SeqPack, dense_scores, dense_scores_plain, ssv_filter, ssv_filter_plain
from .profile import SearchProfile, null1_score

__all__ = ["calibrate", "background_sequences"]

LOG2 = math.log(2.0)


def background_sequences(n: int = 256, L: int = 256, seed: int = 0) -> List["numpy.ndarray"]:
    """The ``n`` random background sequences of length ``L`` that
    :func:`calibrate` scores (the JAX package's draws for the same ``seed``)."""
    rng = numpy.random.default_rng(seed)
    p_bg = BACKGROUND_F / BACKGROUND_F.sum()
    return [rng.choice(20, size=L, p=p_bg).astype(numpy.int32) for _ in range(n)]


def calibrate(
    profiles: Sequence[SearchProfile],
    *,
    device,
    n: int = 256,
    L: int = 256,
    seed: int = 0,
    tailp: float = 0.04,
    backend: str = "auto",
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
    plain = resolve_backend(backend, device) == "torch"
    seqs = background_sequences(n, L, seed)
    bank = TorchBank.build(profiles, device)
    pack = SeqPack(seqs, device)
    ssv, dense = (ssv_filter_plain, dense_scores_plain) if plain else (ssv_filter, dense_scores)
    ssv_sc = ssv(pack, bank).cpu().numpy()
    vit = dense(pack, bank, viterbi=True).cpu().numpy()
    fwd = dense(pack, bank).cpu().numpy()
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
