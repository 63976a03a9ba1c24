"""Plain reference of one domain search: a protein against a profile.

HMMER 3's generic recurrences in log space over numpy float64, one
(sequence, profile) pair at a time: Forward, Backward, posterior decoding,
domain envelopes (``p7_domaindef``'s thresholds rt1 = 0.25, rt2 = 0.10 and an
expected-begin split), the envelope's Forward rescore with the flank length
correction, the null2 bias with HMMER's omega prior, the bit score against
null1, the exponential-tail p-value of the profile's FORWARD statistics and
the optimal-accuracy alignment coordinates.  The semantics are those of the
port's float64 host engine (``gecco_tpu_torch/hmm/engine.py``), written
again here so that the benchmark holds its own copy.

``Arithmetic("bfloat16")`` rounds the parameters and every stored row of the
dynamic programs to bfloat16: the benchmark's control, the reference computed
one precision below the float32 that the port states.
"""

import math
from typing import List, NamedTuple

import numpy

from ..inputs.calibrate import BREAK, LOG2, length_model, null1

NEG = -numpy.inf
OMEGA = 1.0 / 256.0
RT1, RT2 = 0.25, 0.10


class Arithmetic:
    """float64, or bfloat16 storage (round to nearest even after each row)."""

    def __init__(self, name: str = "float64") -> None:
        if name not in ("float64", "bfloat16"):
            raise ValueError(f"unknown arithmetic {name!r}")
        self.name = name

    def __call__(self, x):
        if self.name == "float64":
            return x
        a = numpy.asarray(x, dtype=numpy.float32)
        bits = a.view(numpy.uint32).astype(numpy.uint64)
        rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
        out = rounded.astype(numpy.uint32).view(numpy.float32).astype(numpy.float64)
        out = numpy.where(numpy.isfinite(a), out, a)
        return out if numpy.ndim(x) else float(out)


class Domain(NamedTuple):
    ienv: int
    jenv: int
    target_from: int
    target_to: int
    hmm_from: int
    hmm_to: int
    bits: float
    pvalue: float


def _chain_fwd(b, lt):
    """``d[k] = LSE(b[k], lt[k-1] + d[k-1])``."""
    lt = numpy.where(numpy.isfinite(lt), lt, BREAK)
    T = numpy.concatenate(([0.0], numpy.cumsum(lt)))
    return T + numpy.logaddexp.accumulate(b - T)


def _chain_bwd(c, lt):
    """``d[k] = LSE(c[k], lt[k] + d[k+1])``."""
    lt = numpy.where(numpy.isfinite(lt), lt, BREAK)
    T = numpy.concatenate(([0.0], numpy.cumsum(lt)))
    with numpy.errstate(invalid="ignore"):
        u = numpy.logaddexp.accumulate((c + T)[::-1])[::-1]
    return u - T


class Pair:
    """One protein ``x`` (alphabet codes, 20 = degenerate) against one profile
    (the dict of :func:`benchmark.inputs.calibrate.configure`)."""

    def __init__(self, gm: dict, stats, x: "numpy.ndarray", q: Arithmetic) -> None:
        self.q = q
        self.g = {k: (q(v) if isinstance(v, numpy.ndarray) else v) for k, v in gm.items()}
        self.M = len(gm["tmm"]) - 1
        self.x = numpy.asarray(x)
        self.tau, self.lam = stats

    def forward(self, x):
        g, q, M, L = self.g, self.q, self.M, len(x)
        loop, move = length_model(L)
        e = g["msc"][:, x].T
        fM = numpy.full((L + 1, M + 1), NEG)
        fI, fD = fM.copy(), fM.copy()
        fN, fB, fE, fJ, fC = (numpy.full(L + 1, NEG) for _ in range(5))
        fN[0], fB[0] = 0.0, move
        la = numpy.logaddexp
        for i in range(1, L + 1):
            pM, pI, pD = fM[i - 1], fI[i - 1], fD[i - 1]
            stay = la(la(pM[:-1] + g["tmm"][:-1], pI[:-1] + g["tim"][:-1]), pD[:-1] + g["tdm"][:-1])
            fM[i, 1:] = q(e[i - 1, 1:] + la(stay, fB[i - 1] + g["bm"][1:]))
            fI[i, 1:M] = q(la(pM[1:M] + g["tmi"][1:M], pI[1:M] + g["tii"][1:M]))
            if M > 1:
                fD[i, 2:] = q(_chain_fwd(fM[i, 1:M] + g["tmd"][1:M], g["tdd"][2:M]))
            fE[i] = q(la.reduce(numpy.concatenate([fM[i, 1:], fD[i, 1:]])))
            fJ[i] = q(la(fJ[i - 1] + loop, fE[i] + g["loop_e"]))
            fC[i] = q(la(fC[i - 1] + loop, fE[i] + g["move_e"]))
            fN[i] = q(fN[i - 1] + loop)
            fB[i] = q(la(fN[i] + move, fJ[i] + move))
        return dict(M=fM, I=fI, D=fD, N=fN, B=fB, E=fE, J=fJ, C=fC, score=float(fC[L] + move))

    def backward(self, x):
        g, q, M, L = self.g, self.q, self.M, len(x)
        loop, move = length_model(L)
        e = g["msc"][:, x].T
        bM = numpy.full((L + 1, M + 1), NEG)
        bI, bD = bM.copy(), bM.copy()
        bN, bB, bE, bJ, bC = (numpy.full(L + 1, NEG) for _ in range(5))
        la = numpy.logaddexp
        bC[L] = move
        bE[L] = q(bC[L] + g["move_e"])
        bD[L, 1:] = q(_chain_bwd(numpy.full(M, bE[L]), g["tdd"][1:M]))
        bM[L, M] = bE[L]
        bM[L, 1:M] = q(la(bE[L], g["tmd"][1:M] + bD[L, 2:]))
        for i in range(L - 1, -1, -1):
            en = e[i]
            nM, nI = bM[i + 1], bI[i + 1]
            bB[i] = q(la.reduce(g["bm"][1:] + en[1:] + nM[1:]))
            bJ[i] = q(la(loop + bJ[i + 1], move + bB[i]))
            bC[i] = q(loop + bC[i + 1])
            bN[i] = q(la(loop + bN[i + 1], move + bB[i]))
            bE[i] = q(la(g["loop_e"] + bJ[i], g["move_e"] + bC[i]))
            bI[i, 1:M] = q(la(g["tim"][1:M] + en[2:] + nM[2:], g["tii"][1:M] + nI[1:M]))
            c = la(bE[i], g["tdm"][1:M] + en[2:] + nM[2:])
            bD[i, 1:] = q(_chain_bwd(numpy.append(c, bE[i]), g["tdd"][1:M]))
            bM[i, 1:M] = q(la.reduce(numpy.stack([
                numpy.full(M - 1, bE[i]),
                g["tmm"][1:M] + en[2:] + nM[2:],
                g["tmi"][1:M] + bI[i + 1, 1:M],
                g["tmd"][1:M] + bD[i, 2:],
            ]), axis=0))
            bM[i, M] = bE[i]
        return dict(M=bM, I=bI, D=bD, N=bN, B=bB, E=bE, J=bJ, C=bC, score=float(bN[0]))

    def domains(self) -> List[Domain]:
        """Every domain of the pair, with its bit score and p-value."""
        x, L, q = self.x, len(self.x), self.q
        fwd, bwd = self.forward(x), self.backward(x)
        loop, move = length_model(L)
        total = fwd["score"]
        with numpy.errstate(invalid="ignore", over="ignore"):
            ppM = numpy.nan_to_num(numpy.exp(fwd["M"] + bwd["M"] - total))
            ppI = numpy.nan_to_num(numpy.exp(fwd["I"] + bwd["I"] - total))
            flank = [numpy.concatenate(([0.0], numpy.nan_to_num(
                numpy.exp(fwd[s][:-1] + loop + bwd[s][1:] - total)))) for s in "NJC"]
            pB = numpy.nan_to_num(numpy.exp(fwd["B"] + bwd["B"] - total))
        mocc = q(numpy.clip(1.0 - sum(flank), 0.0, 1.0))
        mocc[0] = 0.0
        btot = numpy.cumsum(pB)
        nullsc = null1(L)
        out = []
        for start, end in _regions(mocc, L):
            for ienv, jenv in _split(btot, start, end):
                Ld = jenv - ienv + 1
                envsc = self.forward(x[ienv - 1 : jenv])["score"] + (L - Ld) * loop
                correction = self._null2(ppM, ppI, mocc, ienv, jenv)
                dombias = numpy.logaddexp(0.0, math.log(OMEGA) + correction)
                bits = (envsc - (nullsc + dombias)) / LOG2
                pvalue = 1.0 if bits <= self.tau else math.exp(-self.lam * (bits - self.tau))
                coords = self._optimal_accuracy(ppM, ppI, ienv, jenv)
                out.append(Domain(ienv, jenv, *coords, float(bits), float(pvalue)))
        return out

    def _null2(self, ppM, ppI, mocc, ienv, jenv) -> float:
        rows = slice(ienv, jenv + 1)
        matocc = ppM[rows, 1:].sum(axis=0)
        insocc = ppI[rows, 1:].sum(axis=0)
        xocc = float((1.0 - mocc[rows]).sum())
        total = matocc.sum() + insocc.sum() + xocc
        if total <= 0:
            return 0.0
        msc = self.g["msc"][1:, :]
        odds = numpy.exp(numpy.where(numpy.isfinite(msc), msc, -745.0))
        null2 = numpy.maximum((matocc @ odds + (insocc.sum() + xocc)) / total, 1e-300)
        return float(numpy.log(null2[self.x[ienv - 1 : jenv]]).sum())

    def _optimal_accuracy(self, ppM, ppI, ienv, jenv):
        """Maximum expected accuracy path over the envelope: ``(target_from,
        target_to, hmm_from, hmm_to)``, 1-based inclusive."""
        g, M, q = self.g, self.M, self.q
        n = jenv - ienv + 1
        low = -1e30
        sM = numpy.full((n, M + 1), low)
        sI, sD = sM.copy(), sM.copy()
        bM = numpy.zeros((n, M + 1), dtype=numpy.int8)
        bI, bD = bM.copy(), bM.copy()
        ok = {k: numpy.isfinite(g[k]) for k in ("tmm", "tmi", "tii", "tim", "tmd", "tdd", "tdm")}
        for r in range(n):
            ppm, ppi = ppM[ienv + r], ppI[ienv + r]
            if r == 0:
                sM[0, 1:] = q(ppm[1:])
            else:
                pM, pI, pD = sM[r - 1], sI[r - 1], sD[r - 1]
                stacked = numpy.stack([
                    numpy.zeros(M),
                    numpy.where(ok["tmm"][:-1], pM[:-1], low),
                    numpy.where(ok["tim"][:-1], pI[:-1], low),
                    numpy.where(ok["tdm"][:-1], pD[:-1], low),
                ])
                choice = numpy.argmax(stacked, axis=0)
                sM[r, 1:] = q(ppm[1:] + numpy.take_along_axis(stacked, choice[None], 0)[0])
                bM[r, 1:] = choice
                fromM = numpy.where(ok["tmi"][1:M], pM[1:M], low)
                fromI = numpy.where(ok["tii"][1:M], pI[1:M], low)
                useM = fromM >= fromI
                sI[r, 1:M] = q(ppi[1:M] + numpy.where(useM, fromM, fromI))
                bI[r, 1:M] = numpy.where(useM, 1, 2)
            gk = numpy.where(ok["tmd"][1:M], sM[r, 1:M], low)
            gate = ok["tdd"][1:M]
            starts = numpy.unique(numpy.concatenate(([0], numpy.flatnonzero(~gate))))
            ends = numpy.append(starts[1:], len(gk))
            for s0, s1 in zip(starts, ends):
                run = numpy.maximum.accumulate(gk[s0:s1])
                prev = numpy.concatenate(([low], run[:-1]))
                sD[r, 2 + s0 : 2 + s1] = run
                bD[r, 2 + s0 : 2 + s1] = numpy.where(gk[s0:s1] >= prev, 1, 3)
        r_end, k_end = numpy.unravel_index(numpy.argmax(sM), sM.shape)
        r, k, state = int(r_end), int(k_end), "M"
        r0, k0 = r, k
        while True:
            if state == "M":
                r0, k0 = r, k
                code = bM[r, k]
                if code == 0 or r == 0:
                    break
                state = {1: "M", 2: "I", 3: "D"}[int(code)]
                r, k = r - 1, k - 1
            elif state == "I":
                state = "M" if bI[r, k] == 1 else "I"
                r -= 1
            else:
                state = "M" if bD[r, k] == 1 else "D"
                k -= 1
        return ienv + r0, ienv + int(r_end), int(k0), int(k_end)


def _regions(mocc, L):
    """Maximal runs with mocc >= rt2 that hold a position >= rt1."""
    occ = numpy.asarray(mocc[1 : L + 1])
    above = occ >= RT2
    if not above.any():
        return []
    edges = numpy.diff(above.astype(numpy.int8))
    starts = numpy.flatnonzero(edges == 1) + 1
    ends = numpy.flatnonzero(edges == -1)
    if above[0]:
        starts = numpy.concatenate(([0], starts))
    if above[-1]:
        ends = numpy.concatenate((ends, [L - 1]))
    peaks = numpy.maximum.reduceat(occ, starts)
    return [(int(s) + 1, int(e) + 1) for s, e, p in zip(starts, ends, peaks) if p >= RT1]


def _split(btot, start, end):
    """Cut a region where the expected number of begins crosses m + 0.5."""
    n = int(round(btot[end] - btot[start - 1]))
    if n <= 1:
        return [(start, end)]
    cuts, target, base = [], 0.5, btot[start - 1]
    for i in range(start, end + 1):
        while btot[i] - base >= target + 1.0 and len(cuts) < n - 1:
            cuts.append(i)
            target += 1.0
    bounds = [start] + [c + 1 for c in cuts] + [end + 1]
    return [(bounds[m], bounds[m + 1] - 1) for m in range(len(bounds) - 1)
            if bounds[m] <= bounds[m + 1] - 1]
