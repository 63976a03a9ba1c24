"""Reference (host, float64, log-space) profile-HMM search engines.

Implements the HMMER3 generic dynamic programs the reference outsources
to pyhmmer's SIMD pipeline (``gecco/hmmer/__init__.py:131-140``):
Forward, Backward, Viterbi and MSV over the local multihit "implicit
probabilistic model", posterior decoding, heuristic domain-envelope
definition, null2 bias correction, and optimal-accuracy alignment
coordinates.  This module is the *numerical ground truth* the batched
device engines are tested against; it follows the
published HMMER3 recurrences (generic_fwdback.c / p7_domaindef.c
structure) re-derived from the model definition.
"""

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy

from .profile import SearchProfile, length_model, null1_score

__all__ = [
    "forward",
    "backward",
    "viterbi_score",
    "msv_score",
    "ssv_score",
    "posterior_decode",
    "define_domains",
    "DomainHit",
    "gumbel_surv",
    "exp_surv",
]

_NEG = -numpy.inf
LOG2 = math.log(2.0)
#: prior probability of the null2 bias model (HMMER's ``p7_bg->omega``)
OMEGA = 1.0 / 256.0
# region-definition thresholds (p7_domaindef defaults)
RT1, RT2, RT3 = 0.25, 0.10, 0.20


def _logsumexp2(a, b):
    return numpy.logaddexp(a, b)


#: stand-in for log(0) inside chain cumsums: far below the f64 underflow
#: point of exp() yet small enough that the prefix-transform cancellation
#: ``(v + BREAK) - BREAK`` keeps ~12 significant digits of ``v``
_BREAK = -1.0e4


def _chain_fwd(b: "numpy.ndarray", lt: "numpy.ndarray") -> "numpy.ndarray":
    """Vectorized first-order log-space chain, forward direction.

    Returns ``d`` with ``d[k] = LSE(b[k], lt[k-1] + d[k-1])`` for
    ``k = 0..n-1`` (``d[-1] = -inf``), via the prefix transform
    ``d = T + cumLSE(b - T)`` where ``T`` is the cumsum of ``lt``.
    """
    lt = numpy.where(numpy.isfinite(lt), lt, _BREAK)
    T = numpy.concatenate(([0.0], numpy.cumsum(lt)))
    return T + numpy.logaddexp.accumulate(b - T)


def _chain_bwd(c: "numpy.ndarray", lt: "numpy.ndarray") -> "numpy.ndarray":
    """Vectorized first-order log-space chain, backward direction.

    Returns ``d`` with ``d[k] = LSE(c[k], lt[k] + d[k+1])`` for
    ``k = n-1..0`` (``d[n] = -inf``).
    """
    lt = numpy.where(numpy.isfinite(lt), lt, _BREAK)
    T = numpy.concatenate(([0.0], numpy.cumsum(lt)))  # T[k] = sum lt[:k]
    with numpy.errstate(invalid="ignore"):
        u = numpy.logaddexp.accumulate((c + T)[::-1])[::-1]
    return u - T


@dataclass
class ForwardMatrices:
    M: "numpy.ndarray"  # [L+1, M+1]
    I: "numpy.ndarray"
    D: "numpy.ndarray"
    N: "numpy.ndarray"  # [L+1]
    B: "numpy.ndarray"
    E: "numpy.ndarray"
    J: "numpy.ndarray"
    C: "numpy.ndarray"
    score: float        # total Forward score in nats (log P(x|profile)/P_len-model)


def _emissions(gm: SearchProfile, x: "numpy.ndarray") -> "numpy.ndarray":
    """Per-row match log-odds ``e[i, k] = msc[k][x_i]``, rows 1..L."""
    return gm.msc[:, x].T  # [L, M+1]


def forward(gm: SearchProfile, x: "numpy.ndarray") -> ForwardMatrices:
    """Full Forward DP (log space)."""
    L, M = len(x), gm.M
    loop, move = length_model(L)
    e = _emissions(gm, x)

    fM = numpy.full((L + 1, M + 1), _NEG)
    fI = numpy.full((L + 1, M + 1), _NEG)
    fD = numpy.full((L + 1, M + 1), _NEG)
    fN = numpy.full(L + 1, _NEG)
    fB = numpy.full(L + 1, _NEG)
    fE = numpy.full(L + 1, _NEG)
    fJ = numpy.full(L + 1, _NEG)
    fC = numpy.full(L + 1, _NEG)

    fN[0] = 0.0
    fB[0] = move

    tmm, tim, tdm = gm.tmm, gm.tim, gm.tdm
    tmi, tii = gm.tmi, gm.tii
    tmd, tdd = gm.tmd, gm.tdd
    bm = gm.bm

    for i in range(1, L + 1):
        ei = e[i - 1]
        prevM, prevI, prevD = fM[i - 1], fI[i - 1], fD[i - 1]
        # match: from M/I/D at k-1 of previous row, or fresh B entry
        stay = _logsumexp2(
            _logsumexp2(prevM[:-1] + tmm[:-1], prevI[:-1] + tim[:-1]),
            prevD[:-1] + tdm[:-1],
        )
        enter = fB[i - 1] + bm[1:]
        fM[i, 1:] = ei[1:] + _logsumexp2(stay, enter)
        # insert (no I_M): emission score 0 in local mode
        fI[i, 1:M] = _logsumexp2(
            prevM[1:M] + tmi[1:M], prevI[1:M] + tii[1:M]
        )
        # delete chain, vectorized: fD[k] = LSE(fM[k-1]+tmd[k-1], fD[k-1]+tdd[k-1])
        if M > 1:
            fD[i, 2:] = _chain_fwd(fM[i, 1:M] + tmd[1:M], tdd[2:M])
        # E: free local exits from every M_k and D_k (esc = 0)
        fE[i] = numpy.logaddexp.reduce(
            numpy.concatenate([fM[i, 1:], fD[i, 1:]])
        )
        fJ[i] = _logsumexp2(fJ[i - 1] + loop, fE[i] + gm.loop_e)
        fC[i] = _logsumexp2(fC[i - 1] + loop, fE[i] + gm.move_e)
        fN[i] = fN[i - 1] + loop
        fB[i] = _logsumexp2(fN[i] + move, fJ[i] + move)

    score = fC[L] + move
    return ForwardMatrices(fM, fI, fD, fN, fB, fE, fJ, fC, float(score))


def backward(gm: SearchProfile, x: "numpy.ndarray") -> ForwardMatrices:
    """Full Backward DP (log space); ``score`` recomputed from row 0."""
    L, M = len(x), gm.M
    loop, move = length_model(L)
    e = _emissions(gm, x)

    bM = numpy.full((L + 1, M + 1), _NEG)
    bI = numpy.full((L + 1, M + 1), _NEG)
    bD = numpy.full((L + 1, M + 1), _NEG)
    bN = numpy.full(L + 1, _NEG)
    bB = numpy.full(L + 1, _NEG)
    bE = numpy.full(L + 1, _NEG)
    bJ = numpy.full(L + 1, _NEG)
    bC = numpy.full(L + 1, _NEG)

    tmm, tim, tdm = gm.tmm, gm.tim, gm.tdm
    tmi, tii = gm.tmi, gm.tii
    tmd, tdd = gm.tmd, gm.tdd
    bm = gm.bm

    # row L
    bC[L] = move
    bE[L] = bC[L] + gm.move_e
    # D along k right-to-left: D_k -> E | D_{k+1} (vectorized chain)
    bD[L, 1:] = _chain_bwd(numpy.full(M, bE[L]), tdd[1:M])
    bM[L, M] = bE[L]
    bM[L, 1:M] = _logsumexp2(bE[L], tmd[1:M] + bD[L, 2:])

    for i in range(L - 1, -1, -1):
        en = e[i]  # emissions of row i+1
        nextM, nextI = bM[i + 1], bI[i + 1]
        bB[i] = numpy.logaddexp.reduce(bm[1:] + en[1:] + nextM[1:])
        bJ[i] = _logsumexp2(loop + bJ[i + 1], move + bB[i])
        bC[i] = loop + bC[i + 1]
        bN[i] = _logsumexp2(loop + bN[i + 1], move + bB[i])
        bE[i] = _logsumexp2(gm.loop_e + bJ[i], gm.move_e + bC[i])
        # inserts: I_k -> M_{k+1} (emit) | I_k (emit)
        bI[i, 1:M] = _logsumexp2(
            tim[1:M] + en[2:] + nextM[2:], tii[1:M] + nextI[1:M]
        )
        # deletes: D_k -> E | D_{k+1} | M_{k+1} (vectorized chain)
        c = _logsumexp2(bE[i], tdm[1:M] + en[2:] + nextM[2:])
        bD[i, 1:] = _chain_bwd(numpy.append(c, bE[i]), tdd[1:M])
        # matches: M_k -> E | M_{k+1} | I_k | D_{k+1}
        bM[i, 1:M] = numpy.logaddexp.reduce(numpy.stack([
            numpy.full(M - 1, bE[i]),
            tmm[1:M] + en[2:] + nextM[2:],
            tmi[1:M] + bI[i + 1, 1:M],
            tmd[1:M] + bD[i, 2:],
        ]), axis=0)
        bM[i, M] = bE[i]

    score = bN[0]
    return ForwardMatrices(bM, bI, bD, bN, bB, bE, bJ, bC, float(score))


def viterbi_score(gm: SearchProfile, x: "numpy.ndarray") -> float:
    """Viterbi (max) score in nats."""
    L, M = len(x), gm.M
    loop, move = length_model(L)
    e = _emissions(gm, x)
    vM = numpy.full(M + 1, _NEG)
    vI = numpy.full(M + 1, _NEG)
    vD = numpy.full(M + 1, _NEG)
    vN, vB, vJ, vC = 0.0, move, _NEG, _NEG
    for i in range(1, L + 1):
        ei = e[i - 1]
        stay = numpy.maximum(
            numpy.maximum(vM[:-1] + gm.tmm[:-1], vI[:-1] + gm.tim[:-1]),
            vD[:-1] + gm.tdm[:-1],
        )
        newM = numpy.full(M + 1, _NEG)
        newM[1:] = ei[1:] + numpy.maximum(stay, vB + gm.bm[1:])
        newI = numpy.full(M + 1, _NEG)
        newI[1:M] = numpy.maximum(vM[1:M] + gm.tmi[1:M], vI[1:M] + gm.tii[1:M])
        newD = numpy.full(M + 1, _NEG)
        d = _NEG
        for k in range(2, M + 1):
            d = max(newM[k - 1] + gm.tmd[k - 1], d + gm.tdd[k - 1])
            newD[k] = d
        E = max(newM[1:].max(), newD[1:].max())
        vJ = max(vJ + loop, E + gm.loop_e)
        vC = max(vC + loop, E + gm.move_e)
        vN = vN + loop
        vB = max(vN + move, vJ + move)
        vM, vI, vD = newM, newI, newD
    return float(vC + move)


def msv_score(gm: SearchProfile, x: "numpy.ndarray") -> float:
    """MSV (multiple segment Viterbi) filter score in nats.

    Match-only model: uniform entry ``2/(M(M+1))``, consecutive matches
    free, free exits, same N/C/J length model.
    """
    L, M = len(x), gm.M
    loop, move = length_model(L)
    tbm = math.log(2.0 / (M * (M + 1.0)))
    e = _emissions(gm, x)
    vM = numpy.full(M + 1, _NEG)
    vN, vB, vJ, vC = 0.0, move, _NEG, _NEG
    for i in range(1, L + 1):
        ei = e[i - 1]
        newM = numpy.full(M + 1, _NEG)
        newM[1:] = ei[1:] + numpy.maximum(vM[:-1], vB + tbm)
        E = newM[1:].max()
        vJ = max(vJ + loop, E + gm.loop_e)
        vC = max(vC + loop, E + gm.move_e)
        vN = vN + loop
        vB = max(vN + move, vJ + move)
        vM = newM
    return float(vC + move)


def ssv_score(gm: SearchProfile, x: "numpy.ndarray") -> float:
    """SSV (single segment Viterbi) filter score in nats.

    MSV without the J state: exactly one high-scoring diagonal segment,
    scored through the same multihit length model.  This is the stage-1
    acceleration filter of HMMER ≥3.1 (and therefore of pyhmmer, which
    the reference wraps at ``gecco/hmmer/__init__.py:131-140``):
    the SSV score is thresholded with the MSV Gumbel calibration.
    ``ssv_score ≤ msv_score`` always (dropping J removes max alternatives).
    """
    L, M = len(x), gm.M
    loop, move = length_model(L)
    tbm = math.log(2.0 / (M * (M + 1.0)))
    e = _emissions(gm, x)
    vM = numpy.full(M + 1, _NEG)
    vN, vB, vC = 0.0, move, _NEG
    for i in range(1, L + 1):
        ei = e[i - 1]
        newM = numpy.full(M + 1, _NEG)
        newM[1:] = ei[1:] + numpy.maximum(vM[:-1], vB + tbm)
        E = newM[1:].max()
        vC = max(vC + loop, E + gm.move_e)
        vN = vN + loop
        vB = vN + move
        vM = newM
    return float(vC + move)


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def gumbel_surv(s: float, mu: float, lam: float) -> float:
    """P(S > s) under a Gumbel distribution (MSV/Viterbi statistics)."""
    y = lam * (s - mu)
    if y > 30.0:
        return math.exp(-y)
    return 1.0 - math.exp(-math.exp(-y))


def exp_surv(s: float, tau: float, lam: float) -> float:
    """P(S > s) under an exponential tail (Forward statistics)."""
    if s <= tau:
        return 1.0
    return math.exp(-lam * (s - tau))


# ---------------------------------------------------------------------------
# posterior decoding and domain definition
# ---------------------------------------------------------------------------

@dataclass
class Posterior:
    ppM: "numpy.ndarray"    # [L+1, M+1] posterior of M_k emitting x_i
    ppI: "numpy.ndarray"
    mocc: "numpy.ndarray"   # [L+1] P(x_i emitted by the core model)
    btot: "numpy.ndarray"   # [L+1] cumulative expected B usage
    etot: "numpy.ndarray"


def posterior_decode(
    gm: SearchProfile, x: "numpy.ndarray",
    fwd: ForwardMatrices, bwd: ForwardMatrices,
) -> Posterior:
    L, M = len(x), gm.M
    loop, move = length_model(L)
    total = fwd.score
    ppM = numpy.exp(fwd.M + bwd.M - total)
    ppI = numpy.exp(fwd.I + bwd.I - total)
    ppM[numpy.isnan(ppM)] = 0.0
    ppI[numpy.isnan(ppI)] = 0.0
    ppN = numpy.zeros(L + 1)
    ppJ = numpy.zeros(L + 1)
    ppC = numpy.zeros(L + 1)
    for i in range(1, L + 1):
        ppN[i] = math.exp(fwd.N[i - 1] + loop + bwd.N[i] - total) if fwd.N[i - 1] != _NEG else 0.0
        ppJ[i] = math.exp(fwd.J[i - 1] + loop + bwd.J[i] - total) if fwd.J[i - 1] != _NEG else 0.0
        ppC[i] = math.exp(fwd.C[i - 1] + loop + bwd.C[i] - total) if fwd.C[i - 1] != _NEG else 0.0
    mocc = numpy.clip(1.0 - (ppN + ppJ + ppC), 0.0, 1.0)
    mocc[0] = 0.0
    pB = numpy.exp(fwd.B + bwd.B - total)
    pE = numpy.exp(fwd.E + bwd.E - total)
    pB[numpy.isnan(pB)] = 0.0
    pE[numpy.isnan(pE)] = 0.0
    return Posterior(ppM, ppI, mocc, numpy.cumsum(pB), numpy.cumsum(pE))


@dataclass
class DomainHit:
    """One reported domain of a (sequence, profile) comparison."""

    ienv: int           # envelope start, 1-based inclusive
    jenv: int
    target_from: int    # alignment start on the sequence, 1-based
    target_to: int
    hmm_from: int       # alignment start on the profile
    hmm_to: int
    envsc: float        # envelope Forward score (nats, length-corrected)
    dombias: float      # null2 bias (nats)
    bitscore: float
    pvalue: float
    i_evalue: float = math.nan


def _find_regions(post: Posterior, L: int) -> List[Tuple[int, int]]:
    """Maximal runs with mocc ≥ rt2 containing a position ≥ rt1."""
    above = numpy.asarray(post.mocc[1 : L + 1]) >= RT2
    if not above.any():
        return []
    edges = numpy.diff(above.astype(numpy.int8))
    starts = numpy.flatnonzero(edges == 1) + 1
    ends = numpy.flatnonzero(edges == -1)
    if above[0]:
        starts = numpy.concatenate(([0], starts))
    if above[-1]:
        ends = numpy.concatenate((ends, [L - 1]))
    peaks = numpy.maximum.reduceat(numpy.asarray(post.mocc[1 : L + 1]), starts)
    return [
        (int(s) + 1, int(e) + 1)
        for s, e, peak in zip(starts, ends, peaks)
        if peak >= RT1
    ]


def _split_region(post: Posterior, start: int, end: int) -> List[Tuple[int, int]]:
    """Split a region into envelopes using expected B counts.

    HMMER resolves multi-domain regions with stochastic traceback
    clustering; we use the deterministic expected-B-crossing
    approximation: a region with expected ``n`` begins is cut where the
    cumulative B mass crosses ``m + 0.5``.
    """
    expected = post.btot[end] - post.btot[start - 1]
    n = int(round(expected))
    if n <= 1:
        return [(start, end)]
    cuts: List[int] = []
    target = 0.5
    base = post.btot[start - 1]
    for i in range(start, end + 1):
        while post.btot[i] - base >= target + 1.0 and len(cuts) < n - 1:
            cuts.append(i)
            target += 1.0
    bounds = [start] + [c + 1 for c in cuts] + [end + 1]
    return [(bounds[m], bounds[m + 1] - 1) for m in range(len(bounds) - 1) if bounds[m] <= bounds[m + 1] - 1]


def _null2_correction(
    gm: SearchProfile, x: "numpy.ndarray", post: Posterior, ienv: int, jenv: int
) -> float:
    """Σ log null2-odds over envelope residues (``p7_GNull2`` analog)."""
    rows = slice(ienv, jenv + 1)
    matocc = post.ppM[rows, 1:].sum(axis=0)           # [M]
    insocc = post.ppI[rows, 1:].sum(axis=0)
    xocc = float((1.0 - post.mocc[rows]).sum())
    total = matocc.sum() + insocc.sum() + xocc
    if total <= 0:
        return 0.0
    odds = numpy.exp(numpy.where(numpy.isfinite(gm.msc[1:, :]), gm.msc[1:, :], -745.0))  # [M, 21]
    null2 = (matocc @ odds + (insocc.sum() + xocc) * 1.0) / total  # [21]
    null2 = numpy.maximum(null2, 1e-300)
    return float(numpy.log(null2[x[ienv - 1 : jenv]]).sum())


def _optimal_accuracy(
    gm: SearchProfile, post: Posterior, ienv: int, jenv: int
) -> Tuple[int, int, int, int]:
    """Alignment coordinates by optimal-accuracy DP over the envelope.

    Maximizes the summed posterior probability of emitted match/insert
    residues along a structurally valid local core path (M/I/D states,
    free local entry/exit at match states), like HMMER's
    ``p7_GOptimalAccuracy``; returns (target_from, target_to, hmm_from,
    hmm_to), 1-based inclusive.
    """
    M = gm.M
    n = jenv - ienv + 1
    NEG = -1e30
    # back codes: 0=local entry, 1=from M diag, 2=from I diag, 3=from D diag
    #             (for I: 1=from M above, 2=from I above; for D: 1=from M left, 3=from D left)
    sM = numpy.full((n, M + 1), NEG)
    sI = numpy.full((n, M + 1), NEG)
    sD = numpy.full((n, M + 1), NEG)
    bM = numpy.zeros((n, M + 1), dtype=numpy.int8)
    bI = numpy.zeros((n, M + 1), dtype=numpy.int8)
    bD = numpy.zeros((n, M + 1), dtype=numpy.int8)
    ok_mm = numpy.isfinite(gm.tmm)
    ok_mi = numpy.isfinite(gm.tmi)
    ok_ii = numpy.isfinite(gm.tii)
    ok_im = numpy.isfinite(gm.tim)
    ok_md = numpy.isfinite(gm.tmd)
    ok_dd = numpy.isfinite(gm.tdd)
    ok_dm = numpy.isfinite(gm.tdm)

    for r in range(n):
        i = ienv + r
        ppm = post.ppM[i]
        ppi = post.ppI[i]
        if r == 0:
            sM[0, 1:] = ppm[1:]
        else:
            prevM, prevI, prevD = sM[r - 1], sI[r - 1], sD[r - 1]
            fromM = numpy.where(ok_mm[:-1], prevM[:-1], NEG)
            fromI = numpy.where(ok_im[:-1], prevI[:-1], NEG)
            fromD = numpy.where(ok_dm[:-1], prevD[:-1], NEG)
            entry = numpy.zeros(M)
            stacked = numpy.stack([entry, fromM, fromI, fromD])
            choice = numpy.argmax(stacked, axis=0)
            sM[r, 1:] = ppm[1:] + numpy.take_along_axis(stacked, choice[None], 0)[0]
            bM[r, 1:] = choice
            # inserts (no I_M)
            fromMi = numpy.where(ok_mi[1:M], prevM[1:M], NEG)
            fromIi = numpy.where(ok_ii[1:M], prevI[1:M], NEG)
            useM = fromMi >= fromIi
            sI[r, 1:M] = ppi[1:M] + numpy.where(useM, fromMi, fromIi)
            bI[r, 1:M] = numpy.where(useM, 1, 2)
        # deletes: same row, a max-prefix recurrence in k
        #   sD[k] = max(g[k], sD[k-1] if ok_dd[k-1])   with
        #   g[k] = sM[k-1] if ok_md[k-1] else NEG
        # vectorized as a running max over the contiguous ok_dd runs
        # (one cummax when the delete chain is unbroken — the common
        # local-profile case); ties keep the M origin like the serial
        # `fromMd >= fromDd` comparison.
        g = numpy.where(ok_md[1:M], sM[r, 1:M], NEG)     # g[k] for k=2..M
        dd_ok = ok_dd[1:M]                                # gate sD[k-1] -> sD[k]
        if dd_ok.all():
            run = numpy.maximum.accumulate(g)
            prev = numpy.concatenate(([NEG], run[:-1]))   # exclusive cummax
            sD[r, 2:] = run
            bD[r, 2:] = numpy.where(g >= prev, 1, 3)
        else:
            # a False gate at j means sD[j+2] takes no carry: j starts
            # a new run
            starts = numpy.unique(numpy.concatenate(([0], numpy.flatnonzero(~dd_ok))))
            ends = numpy.append(starts[1:], len(g))
            for s0, s1 in zip(starts, ends):
                run = numpy.maximum.accumulate(g[s0:s1])
                prev = numpy.concatenate(([NEG], run[:-1]))
                sD[r, 2 + s0 : 2 + s1] = run
                bD[r, 2 + s0 : 2 + s1] = numpy.where(g[s0:s1] >= prev, 1, 3)

    r_end, k_end = numpy.unravel_index(numpy.argmax(sM), sM.shape)
    r, k = int(r_end), int(k_end)
    state = "M"
    r0, k0 = r, k
    while True:
        if state == "M":
            r0, k0 = r, k
            code = bM[r, k]
            if code == 0 or r == 0:
                break
            # M_k(row r) is preceded at (row r-1, node k-1) by M/I/D
            state = {1: "M", 2: "I", 3: "D"}[int(code)]
            r, k = r - 1, k - 1
        elif state == "I":
            code = bI[r, k]
            state = "M" if code == 1 else "I"
            r -= 1
        else:  # D
            code = bD[r, k]
            state = "M" if code == 1 else "D"
            k -= 1
    return (ienv + r0, ienv + int(r_end), int(k0), int(k_end))


def define_domains(
    gm: SearchProfile,
    x: "numpy.ndarray",
    fwd: Optional[ForwardMatrices] = None,
    bwd: Optional[ForwardMatrices] = None,
) -> List[DomainHit]:
    """Find domain envelopes and score them (pipeline-style).

    Per envelope: Forward rescore of the envelope subsequence under the
    full-length model, flank length correction
    ``(L - Ld) * log(L/(L+3))``, null2 bias with omega prior, bit score
    against null1, exponential-tail p-value with the profile's FORWARD
    calibration.
    """
    L = len(x)
    if fwd is None:
        fwd = forward(gm, x)
    if bwd is None:
        bwd = backward(gm, x)
    post = posterior_decode(gm, x, fwd, bwd)
    loop, _ = length_model(L)
    nullsc = null1_score(L)
    tau, lam = gm.hmm.stats.get("FORWARD", (0.0, 0.693))

    hits: List[DomainHit] = []
    for start, end in _find_regions(post, L):
        for ienv, jenv in _split_region(post, start, end):
            Ld = jenv - ienv + 1
            env = forward(gm, x[ienv - 1 : jenv])
            envsc = env.score + (L - Ld) * loop
            correction = _null2_correction(gm, x, post, ienv, jenv)
            dombias = numpy.logaddexp(0.0, math.log(OMEGA) + correction)
            bits = (envsc - (nullsc + dombias)) / LOG2
            pvalue = exp_surv(bits, tau, lam)
            t_from, t_to, h_from, h_to = _optimal_accuracy(gm, post, ienv, jenv)
            hits.append(DomainHit(
                ienv=ienv, jenv=jenv,
                target_from=t_from, target_to=t_to,
                hmm_from=h_from, hmm_to=h_to,
                envsc=float(envsc), dombias=float(dombias),
                bitscore=float(bits), pvalue=float(pvalue),
            ))
    return hits
