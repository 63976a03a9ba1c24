"""The profile-HMM search pipeline.

Port of ``gecco_tpu.hmm.pipeline.SearchPipeline.search``, with the
stages of hmmsearch:

1. **F1 filter** of all (sequence, profile) pairs, Gumbel P-value
   threshold ``F1`` with the composition-bias null: the single-segment
   SSV filter (kernel A) by default, as HMMER >= 3.1, or with
   ``filter_stage="msv"`` HMMER 3.0's multi-segment MSV filter with the
   J loop (kernel I); both are thresholded with the MSV calibration;
2. **Viterbi F2 gate** of the filter survivors (kernel B);
3. **Forward** rescore of the F2 survivors, exponential-tail threshold
   ``F3`` (kernel C);
4. **domain definition** of the F3 / E-value / bit-cutoff candidates
   by :class:`gecco_tpu_torch.hmm.stream.StreamDomains` (kernels D–G),
   as the JAX package's Pallas path: sequence scores and E-values are
   the float32 F3 values, with no float64 rescore, at any sequence
   length.  The float64 host engine defines the domains only of pairs
   whose envelope slots overflow; ``domain_counts`` counts the routes and
   ``host_pairs`` the host engine's pairs.

``bias_filter=False`` (hmmsearch ``--nobias``) drops the
composition-bias null from the F1, F2 and F3 gates (plain null1).
With ``max_filter=True`` (hmmsearch ``--max``) stages 1 and 2 and the
composition-bias filter are skipped: every pair is Forward-scored by
the dense all-pairs kernel H (:func:`~.kernels.dense_scores`) and the
candidates are gated on the E-value (or the bit cutoffs) alone, as in
``gecco_tpu.hmm.pipeline`` (``stage_counts`` has ``F1 == F2 == pairs``;
no filter or Viterbi cells are charged).

``use_accelerator=False`` is the float64 checking path of the JAX
package: every pair survives F1 and F2 unscored (the Viterbi cells are
charged, as there), the float64 host engine (:mod:`.engine`)
Forward-scores every pair, and each F3 / E-value / bit-cutoff candidate
is rescored and gated again in float64 before its domains are defined
by ``engine.define_domains``; the reported scores are the float64 ones.
It builds no sequence pack, uploads no bank and launches no kernel.

``backend="cuda"`` runs the stages through the kernel wrappers (which
take the plain versions for tensors on the CPU); ``backend="torch"``
runs the plain PyTorch versions on whatever device; ``backend="auto"``
is ``"cuda"`` on a card and ``"torch"`` on the CPU.  ``devices=``
(``"all"``, a list of devices, or None) shards the sequences over
devices, one sub-pipeline and one thread each (a list may name one card
twice); a one-device list pins the search to that device.
``stage_counts`` and ``stage_cells`` record the survivor funnel and DP
cells of the last :meth:`SearchPipeline.search`, summed over shards, and
``stage_devices`` counts the shards that ran; the spans ``filter``,
``viterbi``, ``forward`` and ``domains`` of
:data:`~gecco_tpu_torch.profiling.TIMER` time its stages, once a shard.
"""

import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy
import torch

from .._device import BACKENDS, on_device, resolve_backend, resolve_device
from ..profiling import TIMER
from . import engine
from .bank import ProfileBank, TorchBank, bias_logratio
from .engine import DomainHit, exp_surv
from .kernels import (
    SeqPack, dense_scores, dense_scores_plain, msv_filter, msv_filter_plain, pack_mask,
    residue_counts, ssv_filter, ssv_filter_plain, to_host, viterbi_pairs, viterbi_pairs_plain,
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
    "cuda": {"ssv": ssv_filter, "msv": msv_filter, "viterbi": viterbi_pairs,
             "forward": forward_pairs, "dense": dense_scores},
    "torch": {"ssv": ssv_filter_plain, "msv": msv_filter_plain, "viterbi": viterbi_pairs_plain,
              "forward": forward_pairs_plain, "dense": dense_scores_plain},
}


class SearchPipeline:
    """hmmsearch-equivalent many-vs-many search on one device, or sharded
    over several (``devices=``)."""

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
        use_accelerator: bool = True,
        max_filter: bool = False,
        backend: str = "auto",
        filter_stage: str = "ssv",
        bias_filter: bool = True,
        devices=None,
    ) -> None:
        if bit_cutoffs not in (None, "gathering", "noise", "trusted"):
            raise ValueError(f"invalid bit cutoffs: {bit_cutoffs!r}")
        if backend not in BACKENDS:
            raise ValueError(f"invalid backend: {backend!r}")
        if filter_stage not in ("ssv", "msv"):
            raise ValueError(f"invalid filter stage: {filter_stage!r}")
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
        self.use_accelerator = use_accelerator  # False = the float64 host path
        self.max_filter = max_filter  # True = skip filters (hmmsearch --max)
        self.backend = backend
        self.filter_stage = filter_stage
        # composition-bias null of the F1/F2/F3 gates (off: hmmsearch --nobias)
        self.bias_filter = bias_filter
        #: None, "all" or a list of devices to shard the sequences over
        self.devices = devices
        self.stage_counts: Dict[str, int] = {}
        self.stage_cells: Dict[str, float] = {}
        #: shards of the last search that ran (1 without ``devices``)
        self.stage_devices = 1
        #: the routes of the last search's domain definition
        #: (:attr:`~gecco_tpu_torch.hmm.stream.DeviceDomains.counts`; on the
        #: host path every pair is ``host_pairs.length``)
        self.domain_counts: Dict[str, int] = dict.fromkeys(StreamDomains.COUNTS, 0)
        #: the (sequence, profile) pairs of the last search that reached
        #: domain definition (``stage_counts["F3"]`` of them)
        self.candidate_pairs: List[Tuple[int, int]] = []
        #: the (sequence, profile) index arrays the F3 Forward of the last
        #: search rescored (``stage_counts["F2"]`` pairs; None with
        #: ``max_filter`` or when none survived F2)
        self.rescored_pairs: Optional[Tuple["numpy.ndarray", "numpy.ndarray"]] = None
        self._bank = None
        if self.profiles:
            with TIMER.span("build-bank"):
                self._bank = ProfileBank.build(self.profiles)
        self._torch_bank: Optional[TorchBank] = None
        self._logratio = None
        self._subs: Optional[List["SearchPipeline"]] = None

    @property
    def host_pairs(self) -> int:
        """Pairs of the last search whose domains the host engine defined."""
        return self.domain_counts["host_pairs.length"] + self.domain_counts["host_pairs.overflow"]

    @property
    def bank(self) -> TorchBank:
        """The bank's device tensors, uploaded on first use."""
        if self._torch_bank is None:
            with TIMER.span("upload-bank"):
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

    def _reset(self) -> None:
        self.stage_counts = {}
        self.stage_cells = {}
        self.stage_devices = 1
        self.domain_counts = dict.fromkeys(StreamDomains.COUNTS, 0)
        self.candidate_pairs = []
        self.rescored_pairs = None

    # -- several devices ------------------------------------------------------

    def _resolve_devices(self) -> Optional[List[torch.device]]:
        """The devices to shard over: None for one device; ``"all"`` is
        every card when ``device`` is a card, and None when that is one
        card or the CPU; an explicit list is always honoured."""
        if self.devices is None:
            return None
        if isinstance(self.devices, str):
            if self.devices != "all":
                raise ValueError(f"invalid devices: {self.devices!r}")
            if self.device.type != "cuda" or torch.cuda.device_count() <= 1:
                return None
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [resolve_device(d) for d in self.devices] or None

    def _sub_pipelines(self, devices) -> List["SearchPipeline"]:
        """One sub-pipeline a device, sharing the profiles and the host
        bank; each uploads its own bank on its own device."""
        if self._subs is None:
            self._subs = []
            for device in devices:
                sub = SearchPipeline(
                    [], device=device, F1=self.F1, F2=self.F2, F3=self.F3, E=self.E,
                    domE=self.domE, bit_cutoffs=self.bit_cutoffs,
                    use_accelerator=self.use_accelerator, max_filter=self.max_filter,
                    backend=self.backend, filter_stage=self.filter_stage,
                    bias_filter=self.bias_filter,
                )
                sub.profiles = self.profiles
                sub._bank = self._bank
                self._subs.append(sub)
        return self._subs

    def _search_multi(self, sequences, devices) -> List[SequenceHit]:
        """One search, the sequences sharded over ``devices``: each shard
        runs the whole search on its sub-pipeline in its own thread (under
        ``torch.cuda.device`` for a card), with ``Z`` and ``domZ`` of the
        whole batch; hits are re-indexed and merged in (sequence, profile)
        order.  One device, or one sequence, pins the search there."""
        from ..parallel import shard_sequences

        subs = self._sub_pipelines(devices)
        n = len(devices) if len(sequences) > 1 else 1
        shards = shard_sequences(sequences, n) if n > 1 else [list(range(len(sequences)))]
        Z = self.Z if self.Z is not None else float(len(sequences))
        domZ = self.domZ if self.domZ is not None else Z
        results: List[Optional[List[SequenceHit]]] = [None] * n
        errors: List[BaseException] = []
        parent = TIMER.current()

        def work(d: int) -> None:
            try:
                idx = shards[d]
                if not idx:
                    results[d] = []
                    return
                sub = subs[d]
                sub.Z, sub.domZ = Z, domZ
                with on_device(devices[d]), TIMER.attach(parent, str(devices[d])):
                    hits = sub.search([sequences[i] for i in idx])
                for hit in hits:
                    hit.sequence_index = idx[hit.sequence_index]
                results[d] = hits
            except BaseException as exc:  # raised after the join
                errors.append(exc)

        if n == 1:
            work(0)
        else:
            threads = [threading.Thread(target=work, args=(d,)) for d in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            raise errors[0]
        order = {id(gm): p for p, gm in enumerate(self.profiles)}
        merged = [h for r in results if r for h in r]
        merged.sort(key=lambda h: (h.sequence_index, order[id(h.profile)]))
        # accounting over the shards that ran this call (a sub whose shard
        # was empty still holds an earlier batch's numbers)
        self._reset()
        ran = [(shards[d], subs[d]) for d in range(n) if shards[d]]
        self.stage_devices = len(ran)
        candidates: List[Tuple[int, int]] = []
        rescored: List[Tuple["numpy.ndarray", "numpy.ndarray"]] = []
        for idx, sub in ran:
            for key, value in sub.stage_counts.items():
                self.stage_counts[key] = self.stage_counts.get(key, 0) + value
            for key, value in sub.stage_cells.items():
                self.stage_cells[key] = self.stage_cells.get(key, 0.0) + value
            for key, value in sub.domain_counts.items():
                self.domain_counts[key] += value
            candidates.extend((idx[i], p) for i, p in sub.candidate_pairs)
            if sub.rescored_pairs is not None:
                s_arr, p_arr = sub.rescored_pairs
                rescored.append((numpy.asarray(idx, dtype=numpy.int64)[s_arr], p_arr))
        self.candidate_pairs = sorted(candidates)
        if rescored:
            s_arr = numpy.concatenate([s for s, _ in rescored])
            p_arr = numpy.concatenate([p for _, p in rescored])
            order2 = numpy.lexsort((p_arr, s_arr))
            self.rescored_pairs = (s_arr[order2], p_arr[order2])
        return merged

    # -- search ---------------------------------------------------------------

    def search(self, sequences: Sequence["numpy.ndarray"]) -> List[SequenceHit]:
        """Search all profiles against all encoded sequences."""
        self._reset()
        if not self.profiles or not sequences:
            return []
        devices = self._resolve_devices()
        if devices is not None:
            return self._search_multi(sequences, devices)
        host = self._bank
        Z = self.Z if self.Z is not None else float(len(sequences))
        domZ = self.domZ if self.domZ is not None else Z
        lengths = numpy.array([len(x) for x in sequences])
        nullsc = numpy.array([null1_score(int(L)) for L in lengths])
        model_lengths = host.lengths.astype(numpy.float64)

        pack = None
        if not self.use_accelerator:
            vals, s_arr, p_arr, extras = self._score_host(sequences, lengths, model_lengths)
        else:
            backend = resolve_backend(self.backend, self.device)
            bank = self.bank
            with TIMER.span("pack-sequences"):
                pack = SeqPack(sequences, self.device)
            if self.max_filter:
                vals, s_arr, p_arr, extras = self._score_all(
                    pack, bank, backend, lengths, model_lengths)
            else:
                scored = self._score_filtered(pack, bank, backend, lengths, nullsc, model_lengths)
                if scored is None:
                    return []
                vals, s_arr, p_arr, extras = scored

        # ---- stage 3: F3 / E / bit-cutoff gates, domain definition, reporting
        with TIMER.span("domains"):
            if s_arr is None:
                # the dense [S, P] scores of max_filter: gate every pair at once
                bits = (vals - nullsc[:, None]) / LOG2
                tau = host.fwd_tau.astype(numpy.float64)[None, :]
                lam = host.fwd_lambda.astype(numpy.float64)[None, :]
                pv, keep = self._f3_e_gate(bits, bits, tau, lam, Z)
                s_arr, p_arr = numpy.nonzero(keep)
                bits_all, pv_all = bits[keep], pv[keep]
                extras = numpy.zeros(len(s_arr))
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
            self.candidate_pairs = [(i, p) for i, p, _, _ in candidates]

            if self.use_accelerator:
                # domain definition on the device (kernels D-G), as the JAX
                # package's Pallas path; reported scores are the f32 F3 values
                domains = StreamDomains(bank, self.profiles, backend=backend)
                domains_of = domains.define(sequences, self.candidate_pairs, pack=pack)
                self.domain_counts = dict(domains.counts)
            else:
                candidates, domains_of = self._rescore_host(
                    sequences, candidates, extras[keep], nullsc, Z)
                self.domain_counts["host_pairs.length"] = len(domains_of)

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
        self.stage_cells["domains"] = float(sum(
            lengths[i] * model_lengths[p] for i, p, _, _ in candidates
        ))
        return hits

    def _score_host(self, sequences, lengths, model_lengths):
        """``use_accelerator=False``: every pair survives F1 and F2 unscored
        (the Viterbi stage charges its cells but does not run, as in JAX)
        and the float64 host engine Forward-scores each pair.  Returns
        ``(scores, sequences, profiles, bias extras in bits)`` of every
        pair, in (sequence, profile) order."""
        S, P = len(sequences), len(self.profiles)
        pairs = S * P
        cells = float(lengths.sum()) * model_lengths.sum()
        self.stage_counts = {"pairs": pairs, "F1": pairs, "F2": pairs}
        self.stage_cells.update(filter=0.0, viterbi=cells, forward=cells)
        with TIMER.span("forward"):
            s_arr = numpy.repeat(numpy.arange(S, dtype=numpy.int64), P)
            p_arr = numpy.tile(numpy.arange(P, dtype=numpy.int64), S)
            self.rescored_pairs = (s_arr, p_arr)
            vals = numpy.array([engine.forward(self.profiles[p], sequences[i]).score
                                for i, p in zip(s_arr, p_arr)], dtype=numpy.float64)
            extras = self._bias_null(residue_counts(sequences), s_arr, p_arr) / LOG2
        return vals, s_arr, p_arr, extras

    def _bias_null(self, counts, s_arr, p_arr):
        """The composition-bias null of the F2 and F3 gates, as hmmsearch:
        ``filtersc - nullsc`` (nats) of each pair ``(s_arr, p_arr)`` from the
        ``[S, 20]`` residue ``counts``, in float64, clipped at >= 0; 0
        without the bias filter or with ``max_filter``.  Reported scores and
        E-values stay null1-based."""
        if not self.bias_filter or self.max_filter:
            return numpy.zeros(len(s_arr))
        if self._logratio is None:
            self._logratio = bias_logratio(self._bank).astype(numpy.float64)
        delta = numpy.einsum(
            "sk,ks->s", counts[s_arr].astype(numpy.float64), self._logratio[:, p_arr])
        return numpy.maximum(numpy.logaddexp(0.0, delta) - LOG2, 0.0)

    def _rescore_host(self, sequences, candidates, extras, nullsc, Z):
        """The float64 rescore and re-gate of each candidate of the host
        path (an f32-like threshold crossing must not report, say, an
        E-value of 10.002): the bit cutoffs, or else F3 on the
        bias-filtered bits (not with ``max_filter``) and the E-value.
        Returns the rescored candidates and their domains
        (``engine.define_domains``)."""
        rescored: List[Tuple[int, int, float, float]] = []
        domains_of: Dict[Tuple[int, int], List[DomainHit]] = {}
        for (i, p, _, _), extra in zip(candidates, extras):
            gm = self.profiles[p]
            x = sequences[i]
            fwd = engine.forward(gm, x)
            bits64 = (fwd.score - nullsc[i]) / LOG2
            tau, lam = gm.hmm.stats.get("FORWARD", (0.0, LOG2))
            pv64 = exp_surv(bits64, tau, lam)
            if self.bit_cutoffs is not None:
                cutoff = self._cutoff(gm)
                if cutoff is not None and bits64 < cutoff[0]:
                    continue
            else:
                if not self.max_filter and exp_surv(bits64 - extra, tau, lam) > self.F3:
                    continue
                if pv64 * Z > self.E:
                    continue
            domains_of[(i, p)] = engine.define_domains(gm, x, fwd)
            rescored.append((i, p, bits64, pv64))
        return rescored, domains_of

    def _score_all(self, pack, bank, backend, lengths, model_lengths):
        """``max_filter``: every pair survives F1 and F2 unscored; kernel H
        Forward-scores all of them.  Returns the ``[S, P]`` scores."""
        pairs = len(lengths) * len(self.profiles)
        self.stage_counts = {"pairs": pairs, "F1": pairs, "F2": pairs}
        self.stage_cells.update(filter=0.0, viterbi=0.0)
        self.stage_cells["forward"] = float(lengths.sum() * model_lengths.sum())
        with TIMER.span("forward"):
            vals = to_host(_SCORERS[backend]["dense"](pack, bank)).astype(numpy.float64)
        return vals, None, None, None

    def _score_filtered(self, pack, bank, backend, lengths, nullsc, model_lengths):
        """Stages 1 to 2: the SSV or MSV filter, the Viterbi F2 gate and
        the Forward rescore of its survivors.  Returns ``(scores,
        sequences, profiles, bias extras in bits)`` of the F2 survivors,
        or None when none survive."""
        scorers = _SCORERS[backend]
        host = self._bank

        # ---- stage 1: SSV or MSV filter of all pairs; its survivors as
        # (sequence, profile) index arrays, in row-major order
        with TIMER.span("filter"):
            scores = scorers[self.filter_stage](pack, bank)
            keep = pack_mask(scores, pack, bank, self.F1, bias=self.bias_filter)
            s_arr, p_arr = numpy.nonzero(keep)
        self.stage_counts = {"pairs": pack.S * len(self.profiles), "F1": len(s_arr)}
        self.stage_cells["filter"] = float(lengths.sum()) * model_lengths.sum()

        # ---- stage 1.5: Viterbi F2 gate on the filter survivors, against
        # the bias null of each (kept for the F3 gate of the F2 survivors)
        with TIMER.span("viterbi"):
            self.stage_cells["viterbi"] = float((lengths[s_arr] * model_lengths[p_arr]).sum())
            if len(s_arr):
                v_arr = to_host(scorers["viterbi"](pack, bank, s_arr, p_arr))
                extras = self._bias_null(pack.counts_host, s_arr, p_arr) / LOG2
                bits = (v_arr.astype(numpy.float64) - nullsc[s_arr]) / LOG2
                bits -= extras
                pv = _gumbel_surv_vec(host.vit_lambda[p_arr] * (bits - host.vit_mu[p_arr]))
                keep2 = pv <= self.F2
                s_arr, p_arr, extras = s_arr[keep2], p_arr[keep2], extras[keep2]

        # ---- stage 2: Forward rescore of the F2 survivors
        self.stage_counts["F2"] = len(s_arr)
        self.stage_cells["forward"] = float((lengths[s_arr] * model_lengths[p_arr]).sum())
        if not len(s_arr):
            return None
        with TIMER.span("forward"):
            self.rescored_pairs = (s_arr, p_arr)
            vals = to_host(scorers["forward"](pack, bank, s_arr, p_arr)).astype(numpy.float64)
        return vals, s_arr, p_arr, extras
