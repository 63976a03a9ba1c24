"""Search-profile configuration: core HMM → local multihit log-odds model.

Implements the HMMER3 "implicit probabilistic model" configuration the
reference relies on through pyhmmer's search pipeline
(``gecco/hmmer/__init__.py:131-140``): match emission
log-odds against the Easel amino background, uniform-occupancy local
entry ``B->Mk = occ[k]/Z``, free local exits, multihit ``E->{J,C}`` at
probability ½, and the target-length-dependent ``N/C/J`` loop model.
All scores in nats.
"""

import math
from dataclasses import dataclass
from typing import Any, Iterable, List, Mapping, Optional, Tuple

import numpy

from .io import BACKGROUND_F, ProfileHMM

__all__ = [
    "SearchProfile", "configure_local", "length_model", "null1_score", "profiles_from_arrays",
]

LOG2 = math.log(2.0)
_NEG_INF = -numpy.inf


@dataclass
class SearchProfile:
    """A configured local multihit profile in log space (nats).

    Arrays use node indices 1..M (index 0 is a -inf pad):

    * ``msc``  — ``[M+1, 21]`` match log-odds (column 20 = degenerate, 0)
    * ``tmm/tim/tdm`` — ``[M+1]`` transitions into node k+1 (index k)
    * ``tmi/tii``     — ``[M+1]`` match→insert / insert→insert at node k
    * ``tmd/tdd``     — ``[M+1]`` into-delete transitions at node k
    * ``bm``   — ``[M+1]`` local entry ``log B->Mk``
    """

    hmm: ProfileHMM
    msc: "numpy.ndarray"
    tmm: "numpy.ndarray"
    tim: "numpy.ndarray"
    tdm: "numpy.ndarray"
    tmi: "numpy.ndarray"
    tii: "numpy.ndarray"
    tmd: "numpy.ndarray"
    tdd: "numpy.ndarray"
    bm: "numpy.ndarray"
    loop_e: float  # log P(E->J) (= log 0.5 multihit)
    move_e: float  # log P(E->C)

    @property
    def M(self) -> int:
        return self.hmm.length

    @property
    def name(self) -> str:
        return self.hmm.name

    @property
    def accession(self) -> Optional[str]:
        return self.hmm.accession


def _safe_log(p: "numpy.ndarray") -> "numpy.ndarray":
    with numpy.errstate(divide="ignore"):
        return numpy.log(p)


def match_occupancy(hmm: ProfileHMM) -> "numpy.ndarray":
    """Expected match-state occupancy per node (``p7_hmm_CalculateOccupancy``)."""
    M = hmm.length
    t = hmm.trans
    occ = numpy.zeros(M + 1)
    occ[1] = t[0, 0] + t[0, 1]  # 1 - B->D1  (MM + MI out of node 0)
    for k in range(2, M + 1):
        occ[k] = occ[k - 1] * (t[k - 1, 0] + t[k - 1, 1]) + (1.0 - occ[k - 1]) * t[k - 1, 5]
    return occ


def configure_local(hmm: ProfileHMM, multihit: bool = True) -> SearchProfile:
    """Configure a core HMM for local (uni/multi-hit) alignment."""
    M = hmm.length
    # match log-odds; insert emissions score 0 in local mode
    msc = numpy.full((M + 1, 21), _NEG_INF)
    msc[1:, :20] = _safe_log(hmm.match[1:] / BACKGROUND_F[None, :])
    msc[1:, 20] = 0.0  # degenerate residues: odds ratio 1
    msc[0, :] = _NEG_INF

    t = hmm.trans
    logt = _safe_log(t)

    def column(j: int) -> "numpy.ndarray":
        out = numpy.full(M + 1, _NEG_INF)
        out[: M + 1] = logt[:, j]
        return out

    tmm, tmi, tmd = column(0), column(1), column(2)
    tim, tii = column(3), column(4)
    tdm, tdd = column(5), column(6)

    # local entry: B->Mk = occ[k] / sum_i occ[i]*(M-i+1)
    occ = match_occupancy(hmm)
    Z = float(numpy.sum(occ[1:] * (M - numpy.arange(1, M + 1) + 1.0)))
    bm = numpy.full(M + 1, _NEG_INF)
    with numpy.errstate(divide="ignore"):
        bm[1:] = numpy.log(occ[1:] / Z)

    loop_e = math.log(0.5) if multihit else _NEG_INF
    move_e = math.log(0.5) if multihit else 0.0
    return SearchProfile(
        hmm=hmm, msc=msc,
        tmm=tmm, tim=tim, tdm=tdm, tmi=tmi, tii=tii, tmd=tmd, tdd=tdd,
        bm=bm, loop_e=loop_e, move_e=move_e,
    )


def profiles_from_arrays(records: Iterable[Mapping[str, Any]]) -> List[SearchProfile]:
    """Configured profiles from plain per-profile fields.

    Each record maps ``name``, ``accession``, ``length``, ``match`` and
    ``insert`` (``[M+1, 20]`` probabilities), ``trans`` (``[M+1, 7]``),
    ``stats`` and ``cutoffs`` (``{key: (a, b)}``), the fields of a
    :class:`ProfileHMM`; other keys are ignored.  Arrays and mappings
    are copied, so the profiles share nothing with the caller's objects
    (calibrating them in place leaves the source alone).
    """
    profiles = []
    for r in records:
        hmm = ProfileHMM(
            name=str(r["name"]),
            accession=None if r["accession"] is None else str(r["accession"]),
            description=None,
            length=int(r["length"]),
            alphabet="amino",
            match=numpy.array(r["match"], dtype=numpy.float64),
            insert=numpy.array(r["insert"], dtype=numpy.float64),
            trans=numpy.array(r["trans"], dtype=numpy.float64),
            stats={k: tuple(map(float, v)) for k, v in dict(r["stats"]).items()},
            cutoffs={k: tuple(map(float, v)) for k, v in dict(r["cutoffs"]).items()},
        )
        profiles.append(configure_local(hmm))
    return profiles


def length_model(L: int, multihit: bool = True) -> Tuple[float, float]:
    """``(loop, move)`` log-probabilities of the N/C/J length model.

    ``p7_ReconfigLength``: with ``nj`` expected J's (1 for multihit),
    ``loop = L/(L+2+nj)`` and ``move = (2+nj)/(L+2+nj)``.
    """
    nj = 1.0 if multihit else 0.0
    loop = math.log(L / (L + 2.0 + nj)) if L > 0 else _NEG_INF
    move = math.log((2.0 + nj) / (L + 2.0 + nj))
    return loop, move


def null1_score(L: int) -> float:
    """Null-1 length score in nats (``p7_bg_NullOne``).

    ``L = 0`` is defined as 0.0 (``log(1/(0+1))`` with no emissions) so
    a degenerate empty sequence in a batch flows through the pipeline
    scoring no hits instead of raising ``math domain error``.
    """
    if L <= 0:
        return 0.0
    return L * math.log(L / (L + 1.0)) + math.log(1.0 / (L + 1.0))
