"""The profile bank as device tensors.

:class:`ProfileBank` and :func:`bias_logratio` are copies of
``gecco_tpu.hmm.batch.ProfileBank`` (the numpy bank and its
``select``) and ``gecco_tpu.hmm.kernels.bias_logratio`` (the
composition-bias log ratios).  :class:`TorchBank` holds the device-side
tensors the kernels derive from it: the probability-space bank and the
log-space tensors of ``gecco_tpu.hmm.kernels.viterbi_log_tensors``
(recomputed here in numpy, since that function ends in ``jnp``).

Layout: ``[21, P, Mp]`` emissions and ``[8, P, Mp]`` transitions
(``tmm, tim, tdm, tmi, tii, tmd, tdd, bm``), nodes on the last axis, one
dense bank; kernels address a profile's rows by index.  Profiles are
also grouped into power-of-two *width classes* (128 … 4096 nodes): the
kernels launch once per class, sized to it.
"""

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy
import torch

from ..profiling import TIMER
from .profile import SearchProfile

__all__ = [
    "ProfileBank", "TorchBank", "NEG", "MAX_WIDTH", "bias_logratio", "width_class",
    "log_tensors",
]

NEG = -1e30
#: widest profile (nodes) the kernels take
MAX_WIDTH = 4096
_K = 21  # 20 amino acids + degenerate


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class ProfileBank:
    """A set of profiles packed into padded prob-space tensors.

    * ``e_odds`` — ``[21, P, Mp]`` match emission odds (exp of log-odds);
      0 at padded nodes, 1 for the degenerate residue row at real nodes.
    * transition tensors ``[P, Mp]`` (probability space, 0 at pads):
      ``tmm/tim/tdm`` feed node ``k+1`` from ``k``; ``tmi/tii`` stay at
      ``k``; ``tmd/tdd`` feed the delete chain; ``bm`` is local entry.
    * ``lengths`` — real model length per profile.
    """

    e_odds: "numpy.ndarray"
    tmm: "numpy.ndarray"
    tim: "numpy.ndarray"
    tdm: "numpy.ndarray"
    tmi: "numpy.ndarray"
    tii: "numpy.ndarray"
    tmd: "numpy.ndarray"
    tdd: "numpy.ndarray"
    bm: "numpy.ndarray"
    msv_tbm: "numpy.ndarray"  # [P] uniform MSV entry prob 2/(M(M+1))
    lengths: "numpy.ndarray"  # [P] int32
    names: List[str]
    accessions: List[str]
    fwd_tau: "numpy.ndarray"     # [P] FORWARD exponential-tail tau (bits)
    fwd_lambda: "numpy.ndarray"  # [P]
    msv_mu: "numpy.ndarray"      # [P] MSV Gumbel mu (bits)
    msv_lambda: "numpy.ndarray"  # [P]
    vit_mu: "numpy.ndarray"      # [P] VITERBI Gumbel mu (bits)
    vit_lambda: "numpy.ndarray"  # [P]

    @property
    def P(self) -> int:
        return self.e_odds.shape[1]

    @property
    def Mp(self) -> int:
        return self.e_odds.shape[2]

    @classmethod
    def build(cls, profiles: Sequence[SearchProfile], lane: int = 128) -> "ProfileBank":
        P = len(profiles)
        lengths = numpy.array([gm.M for gm in profiles], dtype=numpy.int32)
        Mp = _round_up(int(lengths.max()), lane)
        # node k of profile p sits at lane k-1 of row p: the profiles'
        # nodes end to end, each written to its place by one scatter
        row = numpy.repeat(numpy.arange(P), lengths)
        node = numpy.arange(len(row)) - numpy.repeat(numpy.cumsum(lengths) - lengths, lengths)

        def odds(rows: "numpy.ndarray") -> "numpy.ndarray":
            """``exp(where(isfinite, rows, -745))`` as float32, in place."""
            numpy.copyto(rows, -745.0, where=~numpy.isfinite(rows))
            return numpy.exp(rows, out=rows).astype(numpy.float32)

        e_odds = numpy.zeros((_K, P, Mp), dtype=numpy.float32)
        e_odds[:, row, node] = odds(numpy.concatenate([gm.msc[1:] for gm in profiles])).T
        arrays = {}
        for name in ("tmm", "tim", "tdm", "tmi", "tii", "tmd", "tdd", "bm"):
            arrays[name] = numpy.zeros((P, Mp), dtype=numpy.float32)
            arrays[name][row, node] = odds(
                numpy.concatenate([getattr(gm, name)[1:] for gm in profiles]))
        msv_tbm = (2.0 / (lengths * (lengths + 1.0))).astype(numpy.float32)
        names = [gm.name for gm in profiles]
        accessions = [gm.accession or gm.name for gm in profiles]
        # profiles without STATS MSV/VITERBI calibration must not be
        # dropped by the F1/F2 Gumbel gates (hmmsearch only applies
        # filter thresholds to calibrated models): mu = -inf makes the
        # survival p-value 0, i.e. the gate always passes
        stats = {}
        for key, unset, (loc, lam) in (
            ("FORWARD", (0.0, math.log(2.0)), ("fwd_tau", "fwd_lambda")),
            ("MSV", (-1e30, math.log(2.0)), ("msv_mu", "msv_lambda")),
            ("VITERBI", (-1e30, math.log(2.0)), ("vit_mu", "vit_lambda")),
        ):
            pairs = numpy.array([gm.hmm.stats.get(key, unset) for gm in profiles],
                                dtype=numpy.float64).reshape(P, 2).astype(numpy.float32)
            stats[loc], stats[lam] = pairs[:, 0].copy(), pairs[:, 1].copy()
        uncalibrated = [gm.name for gm in profiles
                        if "MSV" not in gm.hmm.stats or "VITERBI" not in gm.hmm.stats]
        if uncalibrated:
            import warnings

            warnings.warn(
                f"{len(uncalibrated)} profile(s) lack STATS MSV/VITERBI "
                f"calibration (e.g. {uncalibrated[0]!r}); the F1/F2 filter "
                "gates will pass them through unfiltered — calibrate with "
                "gecco_tpu_torch.hmm.calibrate for filter-speed parity",
                stacklevel=2,
            )
        return cls(
            e_odds=e_odds, msv_tbm=msv_tbm, lengths=lengths,
            names=names, accessions=accessions,
            fwd_tau=stats["fwd_tau"], fwd_lambda=stats["fwd_lambda"],
            msv_mu=stats["msv_mu"], msv_lambda=stats["msv_lambda"],
            vit_mu=stats["vit_mu"], vit_lambda=stats["vit_lambda"],
            **arrays,
        )

    def select(self, indices: Sequence[int], lane: int = 128) -> "ProfileBank":
        """Compact a sub-bank of the given profile rows (host-side gather)."""
        idx = numpy.asarray(list(indices), dtype=numpy.int64)
        Mp = _round_up(max(8, int(self.lengths[idx].max())), lane) if len(idx) else lane

        def cols(a: "numpy.ndarray") -> "numpy.ndarray":
            taken = a[..., idx, : min(Mp, a.shape[-1])]
            if taken.shape[-1] < Mp:  # widen with zero pad columns
                pad = [(0, 0)] * (taken.ndim - 1) + [(0, Mp - taken.shape[-1])]
                taken = numpy.pad(taken, pad)
            return numpy.ascontiguousarray(taken)

        return ProfileBank(
            e_odds=cols(self.e_odds),
            tmm=cols(self.tmm), tim=cols(self.tim), tdm=cols(self.tdm),
            tmi=cols(self.tmi), tii=cols(self.tii),
            tmd=cols(self.tmd), tdd=cols(self.tdd), bm=cols(self.bm),
            msv_tbm=self.msv_tbm[idx], lengths=self.lengths[idx],
            names=[self.names[i] for i in idx],
            accessions=[self.accessions[i] for i in idx],
            fwd_tau=self.fwd_tau[idx], fwd_lambda=self.fwd_lambda[idx],
            msv_mu=self.msv_mu[idx], msv_lambda=self.msv_lambda[idx],
            vit_mu=self.vit_mu[idx], vit_lambda=self.vit_lambda[idx],
        )


def bias_logratio(bank: ProfileBank) -> "numpy.ndarray":
    """``log(compo_p[a] / bg[a])`` per profile — the composition filter.

    ``compo_p`` is the profile's mean match emission distribution (the
    analog of HMMER's ``COMPO`` line); derived from the bank's odds
    tensor: ``mean_k e_odds[a, p, k] = compo_p[a] / bg[a]``.
    Returns ``[20, P]`` float32.
    """
    sums = bank.e_odds[:20].sum(axis=2)            # [20, P]
    ratio = sums / numpy.maximum(bank.lengths, 1)[None, :]
    return numpy.log(numpy.maximum(ratio, 1e-30)).astype(numpy.float32)


def width_class(M: int) -> int:
    """Power-of-two node width (at least 128) that holds ``M`` nodes."""
    if M > MAX_WIDTH:
        raise ValueError(f"profile of {M} nodes exceeds the {MAX_WIDTH}-node limit")
    return max(128, 1 << max(0, int(M) - 1).bit_length())


def _logs(a: "numpy.ndarray") -> "numpy.ndarray":
    with numpy.errstate(divide="ignore"):
        return numpy.where(
            a > 0, numpy.log(numpy.maximum(a, 1e-300)), NEG
        ).astype(numpy.float32)


def log_tensors(bank: ProfileBank) -> Tuple["numpy.ndarray", "numpy.ndarray"]:
    """``(e_log [21,P,Mp], trans_log [8,P,Mp])`` for the max-plus kernels.

    As ``gecco_tpu.hmm.kernels.viterbi_log_tensors``: slot 5 holds
    ``log tmd − S`` and slot 6 holds ``S_{j-1}``, where ``S`` is the
    per-profile prefix sum of ``log tdd`` clamped at −1e4, so the delete
    chain is ``D_j = S_{j-1} + max_{i<j}(M_i + log tmd_i − S_i)``.
    """
    e_log = _logs(bank.e_odds)
    log = [_logs(a) for a in (
        bank.tmm, bank.tim, bank.tdm, bank.tmi, bank.tii,
        bank.tmd, bank.tdd, bank.bm,
    )]
    S = numpy.cumsum(
        numpy.maximum(log[6], -1e4), axis=-1, dtype=numpy.float64,
    ).astype(numpy.float32)
    Sm1 = numpy.zeros_like(S)
    Sm1[:, 1:] = S[:, :-1]
    log[5] = log[5] - S
    log[6] = Sm1
    return e_log, numpy.stack(log)


@dataclass
class TorchBank:
    """Device tensors of a :class:`ProfileBank`.

    * ``e_odds`` / ``trans`` — probability space (Forward, kernel C);
    * ``e_log`` / ``trans_log`` — log space, delete chain factored
      (SSV kernel A, Viterbi kernel B);
    * ``tbm_log`` — ``[P]`` log MSV entry ``log 2/(M(M+1))``;
    * ``lengths`` — ``[P]`` int32 model lengths;
    * ``logratio`` — ``[20, P]`` composition-bias log ratios;
    * ``classes`` — ``(width, profile indices)`` per width class.

    ``host`` keeps the numpy bank (calibration stats, names).
    """

    host: ProfileBank
    device: torch.device
    e_odds: torch.Tensor
    trans: torch.Tensor
    e_log: torch.Tensor
    trans_log: torch.Tensor
    tbm_log: torch.Tensor
    lengths: torch.Tensor
    logratio: torch.Tensor
    classes: List[Tuple[int, torch.Tensor]]
    class_of: "numpy.ndarray"   # [P] width of each profile's class

    @property
    def P(self) -> int:
        return self.host.P

    @property
    def Mp(self) -> int:
        return self.host.Mp

    @classmethod
    def build(cls, profiles, device) -> "TorchBank":
        """Build the numpy bank of ``profiles`` and upload it."""
        return cls.from_numpy(ProfileBank.build(profiles), device)

    @classmethod
    def from_numpy(cls, bank: ProfileBank, device) -> "TorchBank":
        """Upload ``bank``, counting the bytes put on ``device`` as
        ``bank_upload_bytes``."""
        e_log, trans_log = log_tensors(bank)
        trans = numpy.stack([
            bank.tmm, bank.tim, bank.tdm, bank.tmi, bank.tii,
            bank.tmd, bank.tdd, bank.bm,
        ])
        with numpy.errstate(divide="ignore"):
            tbm = numpy.log(bank.msv_tbm).astype(numpy.float32)
        class_of = numpy.asarray(
            [width_class(int(m)) for m in bank.lengths], dtype=numpy.int64)

        def put(a):
            a = numpy.ascontiguousarray(a)
            TIMER.count("bank_upload_bytes", a.nbytes)
            return torch.as_tensor(a, device=device)

        classes = [
            (int(w), put(numpy.flatnonzero(class_of == w).astype(numpy.int32)))
            for w in sorted(set(class_of.tolist()))
        ]
        e_odds = put(bank.e_odds)
        return cls(
            host=bank, device=e_odds.device,  # with its index: "cuda" -> "cuda:0"
            e_odds=e_odds, trans=put(trans),
            e_log=put(e_log), trans_log=put(trans_log),
            tbm_log=put(tbm), lengths=put(bank.lengths.astype(numpy.int32)),
            logratio=put(bias_logratio(bank)),
            classes=classes, class_of=class_of,
        )

