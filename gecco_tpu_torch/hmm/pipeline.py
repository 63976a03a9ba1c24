"""The profile-HMM search pipeline on one device.

Port of ``gecco_tpu.hmm.pipeline.SearchPipeline.search`` (single
device), with the stages of hmmsearch:

1. **SSV filter** of all (sequence, profile) pairs, Gumbel P-value
   threshold ``F1`` with the composition-bias null (kernel A);
2. **Viterbi F2 gate** of the filter survivors (kernel B);
3. **Forward** rescore of the F2 survivors, exponential-tail threshold
   ``F3`` (kernel C);
4. **domain definition** of the F3 / E-value / bit-cutoff candidates
   by :class:`gecco_tpu_torch.hmm.stream.StreamDomains` (kernels D–G),
   as the JAX package's Pallas path: sequence scores and E-values are
   the float32 F3 values, with no float64 rescore.  The float64 host
   engine defines the domains only of pairs whose envelope slots
   overflow or whose sequence exceeds 4,096 residues; ``host_pairs``
   counts them.

With ``max_filter=True`` (hmmsearch ``--max``) stages 1 and 2 and the
composition-bias filter are skipped: every pair is Forward-scored by
the dense all-pairs kernel H (:func:`~.kernels.dense_scores`) and the
candidates are gated on the E-value (or the bit cutoffs) alone, as in
``gecco_tpu.hmm.pipeline`` (``stage_counts`` has ``F1 == F2 == pairs``;
no filter or Viterbi cells are charged).

``backend="cuda"`` runs the stages through the kernel wrappers (which
take the plain versions for tensors on the CPU); ``backend="torch"``
runs the plain PyTorch versions on whatever device.  ``stage_counts``,
``stage_seconds`` and ``stage_cells`` record the survivor funnel, wall
seconds and DP cells of the last :meth:`SearchPipeline.search`.
"""

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy

from .._device import resolve_device
from .bank import ProfileBank, TorchBank, bias_logratio
from .engine import DomainHit
from .kernels import (
    SeqPack, dense_scores, dense_scores_plain, flatten_pairs, pack_mask, ssv_filter,
    ssv_filter_plain, viterbi_pairs, viterbi_pairs_plain,
)
from .profile import SearchProfile, null1_score
from .stream import StreamDomains, forward_pairs, forward_pairs_plain

__all__ = ["SequenceHit", "SearchPipeline"]

LOG2 = math.log(2.0)


# ``_gumbel_surv_vec``, ``_exp_surv_vec`` and ``SequenceHit`` are copies
# of ``gecco_tpu.hmm.pipeline``'s
def _gumbel_surv_vec(y):
    """Vectorized Gumbel survival P(S > y) (``esl_gumbel_surv``).

    Two-sided clamp: the ``y > 30`` arm avoids cancellation for tiny
    tails, the lower clamp at −30 avoids overflow RuntimeWarnings for
    junk scores (the result is exactly 1.0 there either way).
    """
    return numpy.where(
        y > 30, numpy.exp(-numpy.minimum(y, 700.0)),
        1.0 - numpy.exp(-numpy.exp(-numpy.clip(y, -30, 30))),
    )


def _exp_surv_vec(bits, tau, lam):
    """Vectorized ``engine.exp_surv``: exponential right-tail survival."""
    return numpy.where(
        bits <= tau, 1.0,
        numpy.exp(-lam * numpy.maximum(bits - tau, 0.0)))


@dataclass
class SequenceHit:
    """All reported domains of one (sequence, profile) comparison."""

    sequence_index: int
    profile: SearchProfile
    score: float              # full-sequence bit score
    pvalue: float
    evalue: float
    domains: List[DomainHit] = field(default_factory=list)

_SCORERS = {
    "cuda": (ssv_filter, viterbi_pairs, forward_pairs, dense_scores),
    "torch": (ssv_filter_plain, viterbi_pairs_plain, forward_pairs_plain, dense_scores_plain),
}


class SearchPipeline:
    """hmmsearch-equivalent many-vs-many search on one device."""

    def __init__(
        self,
        profiles: Sequence[SearchProfile],
        *,
        device,
        Z: Optional[float] = None,
        domZ: Optional[float] = None,
        F1: float = 0.02,
        F2: float = 1e-3,
        F3: float = 1e-5,
        E: float = 10.0,
        domE: float = 10.0,
        bit_cutoffs: Optional[str] = None,
        max_filter: bool = False,
        backend: str = "cuda",
    ) -> None:
        if bit_cutoffs not in (None, "gathering", "noise", "trusted"):
            raise ValueError(f"invalid bit cutoffs: {bit_cutoffs!r}")
        if backend not in _SCORERS:
            raise ValueError(f"invalid backend: {backend!r}")
        self.profiles = list(profiles)
        self.device = resolve_device(device)
        self.Z = Z
        self.domZ = domZ
        self.F1 = F1
        self.F2 = F2
        self.F3 = F3
        self.E = E
        self.domE = domE
        self.bit_cutoffs = bit_cutoffs
        self.max_filter = max_filter  # True = skip filters (hmmsearch --max)
        self.backend = backend
        self.stage_counts: Dict[str, int] = {}
        self.stage_seconds: Dict[str, float] = {}
        self.stage_cells: Dict[str, float] = {}
        #: pairs of the last search whose domains the host engine defined
        self.host_pairs = 0
        self._bank = ProfileBank.build(self.profiles) if self.profiles else None
        self._torch_bank: Optional[TorchBank] = None
        self._logratio = None

    @property
    def bank(self) -> TorchBank:
        """The bank's device tensors, uploaded on first use."""
        if self._torch_bank is None:
            self._torch_bank = TorchBank.from_numpy(self._bank, self.device)
        return self._torch_bank

    def _cutoff(self, gm: SearchProfile) -> Optional[Tuple[float, float]]:
        if self.bit_cutoffs is None:
            return None
        key = {"gathering": "GA", "noise": "NC", "trusted": "TC"}[self.bit_cutoffs]
        cutoff = gm.hmm.cutoffs.get(key)
        if cutoff is None:
            raise ValueError(f"profile {gm.name!r} has no {key} bit cutoffs")
        return cutoff

    def _f3_e_gate(self, bits_all, bits_filt, tau, lam, Z):
        """Vectorized F3 (bias-filtered tail) + E-value gates; no F3
        gate with ``max_filter``."""
        pv_all = _exp_surv_vec(bits_all, tau, lam)
        if self.max_filter:
            keep = numpy.ones(numpy.shape(bits_all), dtype=bool)
        else:
            keep = _exp_surv_vec(bits_filt, tau, lam) <= self.F3
        if self.bit_cutoffs is None:
            keep &= pv_all * Z <= self.E
        return pv_all, keep

    def search(self, sequences: Sequence["numpy.ndarray"]) -> List[SequenceHit]:
        """Search all profiles against all encoded sequences."""
        self.stage_counts = {}
        self.stage_seconds = {}
        self.stage_cells = {}
        self.host_pairs = 0
        if not self.profiles or not sequences:
            return []
        host = self._bank
        bank = self.bank
        Z = self.Z if self.Z is not None else float(len(sequences))
        domZ = self.domZ if self.domZ is not None else Z
        lengths = numpy.array([len(x) for x in sequences])
        nullsc = numpy.array([null1_score(int(L)) for L in lengths])
        model_lengths = host.lengths.astype(numpy.float64)

        pack = SeqPack(sequences, self.device)
        if self.max_filter:
            vals, s_arr, p_arr, extras = self._score_all(pack, bank, lengths, model_lengths)
        else:
            scored = self._score_filtered(pack, bank, lengths, nullsc, model_lengths)
            if scored is None:
                return []
            vals, s_arr, p_arr, extras = scored
        t_stage = time.perf_counter()

        # ---- stage 3: F3 / E / bit-cutoff gates, domain definition, reporting
        if s_arr is None:
            # the dense [S, P] scores of max_filter: gate every pair at once
            bits = (vals - nullsc[:, None]) / LOG2
            tau = host.fwd_tau.astype(numpy.float64)[None, :]
            lam = host.fwd_lambda.astype(numpy.float64)[None, :]
            pv, keep = self._f3_e_gate(bits, bits, tau, lam, Z)
            s_arr, p_arr = numpy.nonzero(keep)
            bits_all, pv_all = bits[keep], pv[keep]
            keep = numpy.ones(len(s_arr), dtype=bool)
        else:
            bits_all = (vals - nullsc[s_arr]) / LOG2
            tau = host.fwd_tau[p_arr].astype(numpy.float64)
            lam = host.fwd_lambda[p_arr].astype(numpy.float64)
            pv_all, keep = self._f3_e_gate(bits_all, bits_all - extras, tau, lam, Z)
        if self.bit_cutoffs is not None:
            kept = numpy.flatnonzero(keep)
            profs, inverse = numpy.unique(p_arr[kept], return_inverse=True)
            ga = numpy.asarray([self._cutoff(self.profiles[p])[0] for p in profs])
            keep[kept] &= bits_all[kept] >= ga[inverse]
        candidates: List[Tuple[int, int, float, float]] = [
            (int(i), int(p), float(b), float(v))
            for i, p, b, v in zip(s_arr[keep], p_arr[keep], bits_all[keep], pv_all[keep])
        ]
        self.stage_counts["F3"] = len(candidates)
        if not candidates:
            return []

        # domain definition on the device (kernels D-G), as the JAX
        # package's Pallas path; reported scores are the f32 F3 values
        domains = StreamDomains(bank, self.profiles, backend=self.backend)
        domains_of = domains.define(
            sequences, [(i, p) for i, p, _, _ in candidates], pack=pack)
        self.host_pairs = domains.host_pairs

        hits: List[SequenceHit] = []
        for i, p, bits, pv in candidates:
            gm = self.profiles[p]
            cutoff = self._cutoff(gm)
            reported: List[DomainHit] = []
            for dom in domains_of.get((i, p), []):
                dom.i_evalue = dom.pvalue * domZ
                if cutoff is None:
                    if dom.i_evalue <= self.domE:
                        reported.append(dom)
                elif dom.bitscore >= cutoff[1]:
                    reported.append(dom)
            if not reported:
                continue
            hits.append(SequenceHit(
                sequence_index=i, profile=gm,
                score=float(bits), pvalue=float(pv), evalue=float(pv) * Z,
                domains=reported,
            ))
        self.stage_counts["reported"] = len(hits)
        self.stage_seconds["domains"] = time.perf_counter() - t_stage
        self.stage_cells["domains"] = float(sum(
            lengths[i] * model_lengths[p] for i, p, _, _ in candidates
        ))
        return hits

    def _score_all(self, pack, bank, lengths, model_lengths):
        """``max_filter``: every pair survives F1 and F2 unscored; kernel H
        Forward-scores all of them.  Returns the ``[S, P]`` scores."""
        pairs = len(lengths) * len(self.profiles)
        self.stage_counts = {"pairs": pairs, "F1": pairs, "F2": pairs}
        self.stage_seconds.update(filter=0.0, viterbi=0.0)
        self.stage_cells.update(filter=0.0, viterbi=0.0)
        t_stage = time.perf_counter()
        self.stage_cells["forward"] = float(lengths.sum() * model_lengths.sum())
        dense = _SCORERS[self.backend][3]
        vals = dense(pack, bank).cpu().numpy().astype(numpy.float64)
        self.stage_seconds["forward"] = time.perf_counter() - t_stage
        return vals, None, None, None

    def _score_filtered(self, pack, bank, lengths, nullsc, model_lengths):
        """Stages 1 to 2: the SSV filter, the Viterbi F2 gate and the
        Forward rescore of its survivors.  Returns ``(scores, sequences,
        profiles, bias extras in bits)`` of the F2 survivors, or None
        when none survive."""
        ssv, viterbi, forward, _dense = _SCORERS[self.backend]
        host = self._bank

        # composition bias filter null of the F1/F2/F3 gates, like
        # hmmsearch; reported scores and E-values stay null1-based
        if self._logratio is None:
            self._logratio = bias_logratio(host).astype(numpy.float64)
        counts = pack.counts_host.astype(numpy.float64)
        extra_mx = None
        if pack.S * host.P <= 64_000_000:
            extra_mx = numpy.maximum(numpy.logaddexp(
                0.0, counts @ self._logratio) - LOG2, 0.0)

        def filter_extra(s_arr, p_arr):
            """``filtersc - nullsc`` (nats) per pair, clipped at >= 0."""
            if extra_mx is not None:
                return extra_mx[s_arr, p_arr]
            delta = numpy.einsum(
                "sk,ks->s", counts[s_arr], self._logratio[:, p_arr])
            return numpy.maximum(numpy.logaddexp(0.0, delta) - LOG2, 0.0)

        def pair_cells(surv: Dict[int, List[int]]) -> float:
            return float(sum(
                lengths[i] * model_lengths[profs].sum() for i, profs in surv.items()
            ))

        # ---- stage 1: SSV filter of all pairs
        t_stage = time.perf_counter()
        keep = pack_mask(ssv(pack, bank), pack, bank, self.F1)
        surviving: Dict[int, List[int]] = {}
        for i in range(pack.S):
            kept = numpy.nonzero(keep[i])[0].tolist()
            if kept:
                surviving[i] = kept
        self.stage_seconds["filter"] = time.perf_counter() - t_stage
        self.stage_cells["filter"] = float(lengths.sum()) * model_lengths.sum()

        # ---- stage 1.5: Viterbi F2 gate on the filter survivors
        self.stage_counts = {
            "pairs": pack.S * len(self.profiles),
            "F1": sum(len(v) for v in surviving.values()),
        }
        t_stage = time.perf_counter()
        self.stage_cells["viterbi"] = pair_cells(surviving)
        if surviving:
            s_arr, p_arr = flatten_pairs(surviving)
            v_arr = viterbi(pack, bank, s_arr, p_arr).cpu().numpy()
            bits = (v_arr.astype(numpy.float64) - nullsc[s_arr]) / LOG2
            bits -= filter_extra(s_arr, p_arr) / LOG2
            pv = _gumbel_surv_vec(host.vit_lambda[p_arr] * (bits - host.vit_mu[p_arr]))
            keep2 = pv <= self.F2
            surviving = {}
            for s, p in zip(s_arr[keep2], p_arr[keep2]):
                surviving.setdefault(int(s), []).append(int(p))
        self.stage_seconds["viterbi"] = time.perf_counter() - t_stage

        # ---- stage 2: Forward rescore of the F2 survivors
        self.stage_counts["F2"] = sum(len(v) for v in surviving.values())
        t_stage = time.perf_counter()
        self.stage_cells["forward"] = pair_cells(surviving)
        if not surviving:
            return None
        s_arr, p_arr = flatten_pairs(surviving)
        vals = forward(pack, bank, s_arr, p_arr).cpu().numpy().astype(numpy.float64)
        self.stage_seconds["forward"] = time.perf_counter() - t_stage
        return vals, s_arr, p_arr, filter_extra(s_arr, p_arr) / LOG2
