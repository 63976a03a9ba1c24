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
    "SearchProfile", "configure_local", "configure_many", "length_model", "null1_score",
    "profiles_from_arrays",
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


def _safe_log(p: "numpy.ndarray", out: Optional["numpy.ndarray"] = None) -> "numpy.ndarray":
    with numpy.errstate(divide="ignore"):
        return numpy.log(p, out=out)


def match_occupancy(hmm: ProfileHMM) -> "numpy.ndarray":
    """Expected match-state occupancy per node (``p7_hmm_CalculateOccupancy``)."""
    rows = hmm.length + 1
    return _occupancy(hmm.trans, numpy.arange(rows), numpy.zeros(rows, dtype=numpy.int64))


def _occupancy(
    trans: "numpy.ndarray", node: "numpy.ndarray", col: "numpy.ndarray"
) -> "numpy.ndarray":
    """:func:`match_occupancy` of profiles laid end to end, one step a node.

    ``trans`` holds the profiles' ``[M+1, 7]`` rows one after another;
    row ``r`` is node ``node[r]`` of profile ``col[r]``.  The recurrence
    ``occ[k] = occ[k-1] (MM + MI)[k-1] + (1 - occ[k-1]) DM[k-1]`` runs
    once per node index over all profiles at once, on ``[max M + 1, P]``
    columns padded with zeros past each profile's end: the operations
    of a lone profile, in the same order.  Returns ``occ`` in the rows
    of ``trans``.
    """
    shape = (int(node.max()) + 1, int(col.max()) + 1)
    stay, enter, occ = numpy.zeros(shape), numpy.zeros(shape), numpy.zeros(shape)
    stay[node, col] = trans[:, 0] + trans[:, 1]
    enter[node, col] = trans[:, 5]
    if shape[0] > 1:
        occ[1] = stay[0]  # 1 - B->D1  (MM + MI out of node 0)
    kept, left = numpy.empty(shape[1]), numpy.empty(shape[1])
    for k in range(2, shape[0]):
        numpy.multiply(occ[k - 1], stay[k - 1], out=kept)
        numpy.subtract(1.0, occ[k - 1], out=left)
        numpy.multiply(left, enter[k - 1], out=left)
        numpy.add(kept, left, out=occ[k])
    return occ[node, col]


def configure_local(hmm: ProfileHMM, multihit: bool = True) -> SearchProfile:
    """Configure a core HMM for local (uni/multi-hit) alignment."""
    return configure_many([hmm], multihit=multihit)[0]


def configure_many(hmms: Iterable[ProfileHMM], multihit: bool = True) -> List[SearchProfile]:
    """:func:`configure_local` of every profile, on whole-library arrays.

    The profiles' ``M + 1`` rows are laid end to end and every
    elementwise step runs once over all of them; each profile's arrays
    are views of those flat arrays.  Only ``Z``, a sum, is taken per
    profile, over the profile's own slice, so that it adds in the order
    of a lone profile.
    """
    hmms = list(hmms)
    if not hmms:
        return []
    rows = numpy.array([h.length + 1 for h in hmms], dtype=numpy.int64)
    starts = numpy.concatenate([[0], numpy.cumsum(rows)])
    first = starts[:-1]                     # each profile's row 0
    col = numpy.repeat(numpy.arange(len(hmms)), rows)
    node = numpy.arange(starts[-1]) - first[col]
    trans = numpy.concatenate([h.trans for h in hmms])

    # match log-odds; insert emissions score 0 in local mode
    odds = numpy.concatenate([h.match for h in hmms])
    numpy.divide(odds, BACKGROUND_F[None, :], out=odds)
    msc = numpy.empty((len(node), 21))
    msc[:, :20] = _safe_log(odds, out=odds)
    msc[:, 20] = 0.0  # degenerate residues: odds ratio 1
    msc[first, :] = _NEG_INF

    # columns MM MI MD IM II DM DD, each one contiguous row
    logt = numpy.ascontiguousarray(_safe_log(trans).T)

    # local entry: B->Mk = occ[k] / sum_i occ[i]*(M-i+1)
    occ = _occupancy(trans, node, col)
    mass = occ * ((rows[col] - 1 - node) + 1.0)     # occ[k] * (M - k + 1)
    spans = list(zip(starts.tolist(), starts[1:].tolist()))
    Z = numpy.array([numpy.sum(mass[a + 1 : b]) for a, b in spans])
    with numpy.errstate(divide="ignore"):
        bm = numpy.log(occ / Z[col])
    bm[first] = _NEG_INF

    loop_e = math.log(0.5) if multihit else _NEG_INF
    move_e = math.log(0.5) if multihit else 0.0
    profiles = []
    for hmm, (a, b) in zip(hmms, spans):
        tmm, tmi, tmd, tim, tii, tdm, tdd = logt[:, a:b]
        profiles.append(SearchProfile(
            hmm=hmm, msc=msc[a:b],
            tmm=tmm, tim=tim, tdm=tdm, tmi=tmi, tii=tii, tmd=tmd, tdd=tdd,
            bm=bm[a:b], loop_e=loop_e, move_e=move_e,
        ))
    return profiles


def profiles_from_arrays(records: Iterable[Mapping[str, Any]]) -> List[SearchProfile]:
    """Configured profiles from plain per-profile fields.

    Each record maps ``name``, ``accession``, ``length``, ``match`` and
    ``insert`` (``[M+1, 20]`` probabilities), ``trans`` (``[M+1, 7]``),
    ``stats`` and ``cutoffs`` (``{key: (a, b)}``), the fields of a
    :class:`ProfileHMM`; other keys are ignored.  Arrays and mappings
    are copied, so the profiles share nothing with the caller's objects
    (calibrating them in place leaves the source alone).
    """
    hmms = []
    for r in records:
        hmms.append(ProfileHMM(
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
        ))
    return configure_many(hmms)


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
