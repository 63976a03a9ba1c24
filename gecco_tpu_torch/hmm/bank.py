"""The profile bank as device tensors.

Counterpart of ``gecco_tpu.hmm.batch.ProfileBank`` (the numpy bank the
JAX package builds, reused here as is) and of the device-side tensors
the JAX kernels derive from it: the log-space tensors of
``gecco_tpu.hmm.kernels.viterbi_log_tensors`` (recomputed here in
numpy, since that function ends in ``jnp``) and the composition-bias
log ratios of ``kernels.bias_logratio``.

Layout: ``[21, P, Mp]`` emissions and ``[8, P, Mp]`` transitions
(``tmm, tim, tdm, tmi, tii, tmd, tdd, bm``), nodes on the last axis, one
dense bank; kernels address a profile's rows by index.  Profiles are
also grouped into power-of-two *width classes* (128 … 4096 nodes): the
kernels launch once per class, sized to it.
"""

from dataclasses import dataclass
from typing import List, Tuple

import numpy
import torch

from gecco_tpu.hmm.batch import ProfileBank
from gecco_tpu.hmm.kernels import bias_logratio

__all__ = ["TorchBank", "NEG", "MAX_WIDTH", "width_class", "log_tensors"]

NEG = -1e30
#: widest profile (nodes) the kernels take
MAX_WIDTH = 4096


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
        e_log, trans_log = log_tensors(bank)
        trans = numpy.stack([
            bank.tmm, bank.tim, bank.tdm, bank.tmi, bank.tii,
            bank.tmd, bank.tdd, bank.bm,
        ])
        with numpy.errstate(divide="ignore"):
            tbm = numpy.log(bank.msv_tbm).astype(numpy.float32)
        class_of = numpy.asarray(
            [width_class(int(m)) for m in bank.lengths], dtype=numpy.int64)
        classes = [
            (int(w), torch.as_tensor(
                numpy.flatnonzero(class_of == w).astype(numpy.int32), device=device))
            for w in sorted(set(class_of.tolist()))
        ]

        def put(a):
            return torch.as_tensor(numpy.ascontiguousarray(a), device=device)

        e_odds = put(bank.e_odds)
        return cls(
            host=bank, device=e_odds.device,  # with its index: "cuda" -> "cuda:0"
            e_odds=e_odds, trans=put(trans),
            e_log=put(e_log), trans_log=put(trans_log),
            tbm_log=put(tbm), lengths=put(bank.lengths.astype(numpy.int32)),
            logratio=put(bias_logratio(bank)),
            classes=classes, class_of=class_of,
        )

