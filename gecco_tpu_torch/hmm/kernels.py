"""Sequence pack, SSV filter (kernel A), Viterbi pair scores (kernel B)
and dense all-pairs scores (kernel H).

Counterparts in ``gecco_tpu.hmm.kernels``:

* :class:`SeqPack` — ``SeqPack``: every residue uploaded once per
  search, here as one flat ``int8`` tensor with offsets, so a sequence
  of any length needs no padded row;
* :func:`ssv_filter` — ``SSVKernel.scores_packed`` through
  ``Bucketed``: SSV scores of all (sequence, profile) pairs;
* :func:`pack_mask` — ``_jit_pack_mask`` in ``Bucketed.masks``: the F1
  Gumbel threshold with the composition-bias null, as plain torch;
* :func:`viterbi_pairs` — ``PairForwardKernel.call_packed`` through
  ``PairBucketed.flat_packed`` (log-space Viterbi): scores of listed
  pairs for the F2 gate;
* :func:`dense_scores` — ``ForwardKernel`` / ``ViterbiKernel`` through
  ``Bucketed`` (``_pallas_fwd``): Forward or Viterbi scores of every
  pair, the rescore of the ``max_filter`` search (hmmsearch ``--max``).

The plain probability-space steps (:func:`_forward_step` and its
max-plus form :func:`_viterbi_step`) are shared with the plain versions
of kernels C, D and G in ``stream.py``.

Each kernel wrapper dispatches on the device of the tensors it is
given: CPU tensors go to the plain PyTorch version in this module, CUDA
tensors launch the kernel (``csrc/``) or raise.  The plain versions
compute the same function and are what the kernels are checked against.
"""

import math
from typing import Dict, List, Sequence, Tuple

import numpy
import torch

from .. import _build
from .bank import NEG, TorchBank
from .profile import length_model, null1_score

__all__ = [
    "SeqPack", "ssv_filter", "ssv_filter_plain", "pack_mask",
    "viterbi_pairs", "viterbi_pairs_plain", "flatten_pairs",
    "dense_scores", "dense_scores_plain",
]

LOG2 = math.log(2.0)
LOG_HALF = math.log(0.5)
#: smallest normal float32; kernel H flushes values below it to zero
_FLT_MIN = float(numpy.finfo(numpy.float32).tiny)
#: cells (rows x nodes) of one plane of the plain dense scorer
_PLAIN_CELLS = 1 << 22


class SeqPack:
    """A batch of encoded sequences resident on one device.

    ``xs`` holds every residue back to back (``int8``); sequence ``s``
    is ``xs[offsets[s] : offsets[s] + lens[s]]``.  Per-sequence length
    model terms (``loops_log``/``moves_log`` and their exponentials), the
    null-1 scores and residue counts ride along; host copies keep
    accounting off the device.
    """

    def __init__(self, sequences: Sequence["numpy.ndarray"], device):
        S = len(sequences)
        self.S = S
        lens = numpy.array([len(x) for x in sequences], dtype=numpy.int32)
        offsets = numpy.zeros(S, dtype=numpy.int64)
        if S:
            offsets[1:] = numpy.cumsum(lens, dtype=numpy.int64)[:-1]
        flat = numpy.zeros(max(1, int(lens.sum())), dtype=numpy.int8)
        loops_log = numpy.zeros(S, dtype=numpy.float32)
        moves_log = numpy.zeros(S, dtype=numpy.float32)
        nullsc = numpy.zeros(S, dtype=numpy.float32)
        counts = numpy.zeros((S, 20), dtype=numpy.float32)
        for i, x in enumerate(sequences):
            x = numpy.minimum(numpy.asarray(x), 20)
            L = len(x)
            flat[offsets[i] : offsets[i] + L] = x
            loops_log[i], moves_log[i] = length_model(L)
            nullsc[i] = null1_score(L)
            counts[i] = numpy.bincount(x, minlength=21)[:20]
        self.lens_host = lens
        self.counts_host = counts

        def put(a):
            return torch.as_tensor(a, device=device)

        self.xs = put(flat)
        self.device = self.xs.device  # with its index: "cuda" -> "cuda:0"
        self.offsets = put(offsets)
        self.lens = put(lens)
        self.loops_log = put(loops_log)
        self.moves_log = put(moves_log)
        self.loops_exp = torch.exp(self.loops_log)
        self.moves_exp = torch.exp(self.moves_log)
        self.nullsc = put(nullsc)
        self.counts = put(counts)
        self._padded = None

    def padded(self) -> torch.Tensor:
        """``[S, Lmax]`` int64 residues, zero past each length (plain paths)."""
        if self._padded is None:
            Lmax = max(1, int(self.lens_host.max(initial=0)))
            lens = self.lens.long()
            pos = torch.arange(Lmax, device=self.device)
            index = (self.offsets[:, None] + pos[None, :]).clamp(max=self.xs.numel() - 1)
            xs = self.xs.long()[index]
            self._padded = torch.where(pos[None, :] < lens[:, None], xs, 0)
        return self._padded


def _check(t: torch.Tensor, dtype, name: str, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_pack_bank(pack: SeqPack, bank: TorchBank, log_space: bool) -> None:
    device = bank.device
    for name, t, dtype in (
        ("xs", pack.xs, torch.int8), ("offsets", pack.offsets, torch.int64),
        ("lens", pack.lens, torch.int32),
        ("loops", pack.loops_log if log_space else pack.loops_exp, torch.float32),
        ("moves", pack.moves_log if log_space else pack.moves_exp, torch.float32),
        ("lengths", bank.lengths, torch.int32),
        ("emissions", bank.e_log if log_space else bank.e_odds, torch.float32),
        ("transitions", bank.trans_log if log_space else bank.trans, torch.float32),
    ):
        _check(t, dtype, name, device)
    if tuple(bank.e_log.shape) != (21, bank.P, bank.Mp):
        raise ValueError("bank emissions must be [21, P, Mp]")


def _kernel_device(pack: SeqPack, bank: TorchBank) -> str:
    """``"cpu"`` (plain version) or ``"cuda"`` (kernel) for these tensors."""
    if pack.device != bank.device:
        raise ValueError(f"pack on {pack.device}, bank on {bank.device}")
    if bank.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device: {bank.device}")
    return bank.device.type


# ---------------------------------------------------------------------------
# kernel A: SSV filter
# ---------------------------------------------------------------------------

def ssv_filter(pack: SeqPack, bank: TorchBank) -> torch.Tensor:
    """SSV filter scores (nats) of every pair, ``[S, P]`` on the device."""
    if _kernel_device(pack, bank) == "cpu":
        return ssv_filter_plain(pack, bank)
    _check_pack_bank(pack, bank, log_space=True)
    _check(bank.tbm_log, torch.float32, "tbm", bank.device)
    out = torch.empty((pack.S, bank.P), dtype=torch.float32, device=bank.device)
    if pack.S == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(bank.device):
        stream = torch.cuda.current_stream(bank.device).cuda_stream
        for width, idx in bank.classes:
            _check(idx, torch.int32, "profile index", bank.device)
            code = lib.gecco_ssv_filter(
                pack.xs.data_ptr(), pack.offsets.data_ptr(), pack.lens.data_ptr(),
                pack.loops_log.data_ptr(), pack.moves_log.data_ptr(), pack.S,
                bank.e_log.data_ptr(), bank.tbm_log.data_ptr(), idx.data_ptr(),
                int(idx.numel()), bank.lengths.data_ptr(), bank.P, bank.Mp, width,
                out.data_ptr(), stream,
            )
            _build.check(code, "gecco_ssv_filter")
            _build.launches["ssv_filter"] += 1
    return out


def ssv_filter_plain(pack: SeqPack, bank: TorchBank) -> torch.Tensor:
    """Plain PyTorch SSV filter: the recurrence over ``[S, P, W]`` planes."""
    device = bank.device
    out = torch.full((pack.S, bank.P), NEG, dtype=torch.float32, device=device)
    if pack.S == 0:
        return out
    xs = pack.padded()
    lens = pack.lens.long()
    loop = pack.loops_log[:, None, None]
    for width, idx in bank.classes:
        W = min(width, bank.Mp)
        prof = idx.long()
        e = bank.e_log[:, prof, :W]                                  # [21, Pc, W]
        cb0 = bank.tbm_log[prof][None, :, None] + pack.moves_log[:, None, None]
        A = torch.full((pack.S, len(prof), W), NEG, dtype=torch.float32, device=device)
        G = A.clone()
        first = A[..., :1].clone()
        for i in range(xs.shape[1]):
            alive = (i < lens)[:, None, None]
            shifted = torch.cat([first, A[..., :-1]], dim=2)
            An = (e[xs[:, i]] - loop) + torch.maximum(shifted, cb0)
            A = torch.where(alive, An, A)
            G = torch.where(alive, torch.maximum(G, An), G)
        tail = (lens.float() * pack.loops_log + LOG_HALF) + pack.moves_log
        out[:, prof] = G.amax(dim=2) + tail[:, None]
    out[lens == 0] = NEG
    return out


def pack_mask(scores: torch.Tensor, pack: SeqPack, bank: TorchBank,
              F1: float) -> "numpy.ndarray":
    """F1 survivor matrix ``[S, P]`` (bool, host) from filter scores.

    ``pv <= F1`` rewritten as a per-pair score threshold (the Gumbel
    survival is monotone), against the null-1 score plus the composition
    filter null clipped at >= 0 — as ``gecco_tpu.hmm.kernels.Bucketed.masks``
    with ``bias=True``.
    """
    if F1 < 1e-13:  # below the exact branch's resolution: tail form
        y_thr = -math.log(F1)
    else:
        y_thr = -math.log(-math.log1p(-F1))
    host = bank.host
    thr = LOG2 * (host.msv_mu + y_thr / host.msv_lambda)
    delta = pack.counts @ bank.logratio
    null = pack.nullsc[:, None] + torch.clamp(
        torch.logaddexp(torch.zeros_like(delta), delta) - LOG2, min=0.0)
    keep = scores >= null + torch.as_tensor(thr, device=bank.device)[None, :]
    return keep.cpu().numpy()


# ---------------------------------------------------------------------------
# pair lists (F2 / F3)
# ---------------------------------------------------------------------------

def flatten_pairs(survivors: Dict[int, List[int]]) -> Tuple["numpy.ndarray", "numpy.ndarray"]:
    """``(sequence, profile)`` index arrays of a survivor dict, in key order."""
    keys = sorted(survivors)
    if not keys:
        z = numpy.zeros(0, dtype=numpy.int64)
        return z, z.copy()
    s = numpy.concatenate([numpy.full(len(survivors[i]), i, numpy.int64) for i in keys])
    p = numpy.concatenate([numpy.asarray(survivors[i], numpy.int64) for i in keys])
    return s, p


def launch_rows(fn_name: str, counter: str, pack: SeqPack, bank: TorchBank,
                seq: torch.Tensor, prof: torch.Tensor, width: int, *tail: torch.Tensor,
                log_space: bool, stride=None) -> None:
    """Launch kernel ``fn_name`` once over the rows ``(seq[r], prof[r])``.

    Every row kernel (B–G) takes the pack, the rows' ``int32`` indices,
    the bank and ``width``; kernels D–G add ``stride``.  ``tail`` are the
    kernel's own arrays, passed in order before the stream.
    """
    _check_pack_bank(pack, bank, log_space)
    for name, t in (("row sequences", seq), ("row profiles", prof)):
        _check(t, torch.int32, name, bank.device)
    for t in tail:
        if t.device != bank.device or not t.is_contiguous():
            raise ValueError(f"{fn_name}: argument not contiguous on {bank.device}")
    n = seq.numel()
    if n == 0:
        return
    emissions = bank.e_log if log_space else bank.e_odds
    trans = bank.trans_log if log_space else bank.trans
    loops = pack.loops_log if log_space else pack.loops_exp
    moves = pack.moves_log if log_space else pack.moves_exp
    fn = getattr(_build.library(), fn_name)
    with torch.cuda.device(bank.device):
        stream = torch.cuda.current_stream(bank.device).cuda_stream
        code = fn(
            pack.xs.data_ptr(), pack.offsets.data_ptr(), pack.lens.data_ptr(),
            loops.data_ptr(), moves.data_ptr(), seq.data_ptr(), prof.data_ptr(), n,
            emissions.data_ptr(), trans.data_ptr(), bank.lengths.data_ptr(),
            bank.P, bank.Mp, width, *(() if stride is None else (stride,)),
            *[t.data_ptr() for t in tail], stream,
        )
    _build.check(code, fn_name)
    _build.launches[counter] += 1


def launch_pairs(fn_name: str, counter: str, pack: SeqPack, bank: TorchBank,
                 seq_idx, prof_idx, log_space: bool) -> torch.Tensor:
    """Launch a pair kernel once per width class; scores in input order."""
    _check_pack_bank(pack, bank, log_space)
    seq_idx = numpy.asarray(seq_idx, dtype=numpy.int64)
    prof_idx = numpy.asarray(prof_idx, dtype=numpy.int64)
    n = len(seq_idx)
    out = torch.empty(n, dtype=torch.float32, device=bank.device)
    if n == 0:
        return out
    if seq_idx.min() < 0 or seq_idx.max() >= pack.S:
        raise IndexError("pair sequence index out of range")
    if prof_idx.min() < 0 or prof_idx.max() >= bank.P:
        raise IndexError("pair profile index out of range")
    width = bank.class_of[prof_idx]
    order = numpy.argsort(width, kind="stable")
    seq_t = torch.as_tensor(seq_idx[order].astype(numpy.int32), device=bank.device)
    prof_t = torch.as_tensor(prof_idx[order].astype(numpy.int32), device=bank.device)
    scores = torch.empty(n, dtype=torch.float32, device=bank.device)
    bounds = numpy.flatnonzero(numpy.diff(width[order])) + 1
    for a, b in zip(numpy.concatenate(([0], bounds)), numpy.concatenate((bounds, [n]))):
        launch_rows(fn_name, counter, pack, bank, seq_t[a:b], prof_t[a:b],
                    int(width[order[a]]), scores[a:b], log_space=log_space)
    out[torch.as_tensor(order, device=bank.device)] = scores
    return out


def pair_groups(bank: TorchBank, seq_idx, prof_idx, chunk: int):
    """Plain-path batches: ``(positions, seq, prof, width)`` per class chunk."""
    seq_idx = numpy.asarray(seq_idx, dtype=numpy.int64)
    prof_idx = numpy.asarray(prof_idx, dtype=numpy.int64)
    width = bank.class_of[prof_idx] if len(prof_idx) else numpy.zeros(0, numpy.int64)
    for w in sorted(set(width.tolist())):
        sel = numpy.flatnonzero(width == w)
        for c0 in range(0, len(sel), chunk):
            part = sel[c0 : c0 + chunk]
            yield (torch.as_tensor(part, device=bank.device),
                   torch.as_tensor(seq_idx[part], device=bank.device),
                   torch.as_tensor(prof_idx[part], device=bank.device),
                   min(int(w), bank.Mp))


# ---------------------------------------------------------------------------
# kernel B: Viterbi pair scores
# ---------------------------------------------------------------------------

def viterbi_pairs(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx) -> torch.Tensor:
    """Viterbi scores (nats) of pairs ``(seq_idx[r], prof_idx[r])``, ``[n]``."""
    if _kernel_device(pack, bank) == "cpu":
        return viterbi_pairs_plain(pack, bank, seq_idx, prof_idx)
    return launch_pairs("gecco_viterbi_pairs", "viterbi_pairs", pack, bank,
                        seq_idx, prof_idx, log_space=True)


def viterbi_pairs_plain(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx,
                        chunk: int = 4096) -> torch.Tensor:
    """Plain PyTorch log-space Viterbi over ``[pairs, W]`` planes.

    The delete chain is the exact prefix max (``torch.cummax``) of the
    factored form ``D_j = S_{j-1} + max_{i<j}(M_i + log tmd_i − S_i)``.
    """
    device = bank.device
    out = torch.empty(len(seq_idx), dtype=torch.float32, device=device)
    xs_all = pack.padded()
    for pos, s, p, W in pair_groups(bank, seq_idx, prof_idx, chunk):
        R = len(pos)
        tmm, tim, tdm, tmi, tii, tmdS, Sm1, bm = bank.trans_log[:, p, :W]
        lens = pack.lens.long()[s]
        loop = pack.loops_log[s][:, None]
        move = pack.moves_log[s][:, None]
        xs = xs_all[s]
        neg = torch.full((R, W), NEG, dtype=torch.float32, device=device)
        col = neg[:, :1]
        M, I, D = neg, neg, neg
        N = torch.zeros((R, 1), dtype=torch.float32, device=device)
        B = move.clone()
        J, C = col.clone(), col.clone()
        for i in range(int(lens.max())):
            alive = (i < lens)[:, None]
            e = bank.e_log[xs[:, i], p, :W]
            stay = torch.maximum(torch.maximum(M + tmm, I + tim), D + tdm)
            Mn = e + torch.maximum(torch.cat([col, stay[:, :-1]], 1), B + bm)
            In = torch.maximum(M + tmi, I + tii)
            w = torch.cat([col, (Mn + tmdS)[:, :-1]], 1)
            Dn = torch.cummax(w, dim=1).values + Sm1
            Elm = Mn.amax(dim=1, keepdim=True) + LOG_HALF
            Jn = torch.maximum(J + loop, Elm)
            Cn = torch.maximum(C + loop, Elm)
            Nn = N + loop
            Bn = torch.maximum(Nn, Jn) + move
            M, I, D = (torch.where(alive, a, b) for a, b in ((Mn, M), (In, I), (Dn, D)))
            N, B, J, C = (torch.where(alive, a, b) for a, b in ((Nn, N), (Bn, B), (Jn, J), (Cn, C)))
        out[pos] = (C + move)[:, 0]
    return out


# ---------------------------------------------------------------------------
# the plain probability-space steps (kernels C, D, G and H)
# ---------------------------------------------------------------------------

def _affine_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``d -> a*d + b`` along dim 1 (doubling, full depth)."""
    width = a.shape[1]
    shift = 1
    while shift < width:
        prev_a = torch.cat([torch.ones_like(a[:, :shift]), a[:, :-shift]], 1)
        prev_b = torch.cat([torch.zeros_like(b[:, :shift]), b[:, :-shift]], 1)
        b = prev_b * a + b
        a = prev_a * a
        shift *= 2
    return b


def _shift_right(a: torch.Tensor, fill, by: int = 1) -> torch.Tensor:
    return torch.cat([torch.full_like(a[:, :by], fill), a[:, :-by]], 1)


def _forward_step(M, I, D, N, B, J, C, e, tr, shifted_tdd, loop, move):
    """One Forward step (probability space); returns the new states and their total."""
    tmm, tim, tdm, tmi, tii, tmd, _tdd, bm = tr
    col = torch.zeros_like(M[:, :1])
    stay = M * tmm + I * tim + D * tdm
    Mn = e * (torch.cat([col, stay[:, :-1]], 1) + B * bm)
    In = M * tmi + I * tii
    Dn = _affine_scan(shifted_tdd, torch.cat([col, (Mn * tmd)[:, :-1]], 1))
    E = (Mn + Dn).sum(dim=1, keepdim=True)
    Jn = J * loop + E * 0.5
    Cn = C * loop + E * 0.5
    Nn = N * loop
    Bn = (Nn + Jn) * move
    return Mn, In, Dn, Nn, Bn, Jn, Cn, E + Bn + Nn + Cn + 1e-30




def _max_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``d -> max(a*d, b)`` along dim 1 (doubling, full depth)."""
    width = a.shape[1]
    shift = 1
    while shift < width:
        prev_a = torch.cat([torch.ones_like(a[:, :shift]), a[:, :-shift]], 1)
        prev_b = torch.cat([torch.zeros_like(b[:, :shift]), b[:, :-shift]], 1)
        b = torch.maximum(prev_b * a, b)
        a = prev_a * a
        shift *= 2
    return b


def _viterbi_step(M, I, D, N, B, J, C, e, tr, shifted_tdd, loop, move):
    """One Viterbi step in probability space (max-plus): :func:`_forward_step`
    with sums taken as maxima and ``E`` the maximum of ``M`` alone."""
    tmm, tim, tdm, tmi, tii, tmd, _tdd, bm = tr
    col = torch.zeros_like(M[:, :1])
    stay = torch.maximum(torch.maximum(M * tmm, I * tim), D * tdm)
    Mn = e * torch.maximum(torch.cat([col, stay[:, :-1]], 1), B * bm)
    In = torch.maximum(M * tmi, I * tii)
    Dn = _max_scan(shifted_tdd, torch.cat([col, (Mn * tmd)[:, :-1]], 1))
    E = Mn.amax(dim=1, keepdim=True)
    Jn = torch.maximum(J * loop, E * 0.5)
    Cn = torch.maximum(C * loop, E * 0.5)
    Nn = N * loop
    Bn = torch.maximum(Nn, Jn) * move
    return Mn, In, Dn, Nn, Bn, Jn, Cn, E + Bn + Nn + Cn + 1e-30


# ---------------------------------------------------------------------------
# kernel H: dense all-pairs Forward / Viterbi scores
# ---------------------------------------------------------------------------

def dense_scores(pack: SeqPack, bank: TorchBank, *, viterbi: bool = False) -> torch.Tensor:
    """Forward (or Viterbi) scores (nats) of every pair, ``[S, P]`` on the device.

    The counterpart of ``ForwardKernel`` / ``ViterbiKernel`` through
    ``Bucketed``: one launch per width class of the bank, every
    sequence against every profile of the class.  The score is the TPU
    kernel's ``log(C move + 1e-38) + ls`` as XLA computes it (the
    kernel's interpret mode): 1e-38 is a float32 subnormal, which XLA
    flushes to zero, and so is a subnormal ``C move``; an empty sequence
    (``C = 0``) scores −inf.
    """
    if _kernel_device(pack, bank) == "cpu":
        return dense_scores_plain(pack, bank, viterbi=viterbi)
    _check_pack_bank(pack, bank, log_space=False)
    out = torch.empty((pack.S, bank.P), dtype=torch.float32, device=bank.device)
    if pack.S == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(bank.device):
        stream = torch.cuda.current_stream(bank.device).cuda_stream
        for width, idx in bank.classes:
            _check(idx, torch.int32, "profile index", bank.device)
            code = lib.gecco_dense_scores(
                pack.xs.data_ptr(), pack.offsets.data_ptr(), pack.lens.data_ptr(),
                pack.loops_exp.data_ptr(), pack.moves_exp.data_ptr(), pack.S,
                bank.e_odds.data_ptr(), bank.trans.data_ptr(), idx.data_ptr(),
                int(idx.numel()), bank.lengths.data_ptr(), bank.P, bank.Mp, width,
                int(viterbi), out.data_ptr(), stream,
            )
            _build.check(code, "gecco_dense_scores")
            _build.launches["dense_scores"] += 1
    return out


def dense_scores_plain(pack: SeqPack, bank: TorchBank, *, viterbi: bool = False) -> torch.Tensor:
    """Plain PyTorch kernel H over ``[pairs, W]`` planes of at most ``_PLAIN_CELLS`` cells.

    The recurrence of :func:`forward_pairs_plain` (or, with ``viterbi``,
    its max-plus form with the exact prefix-max delete chain of
    :func:`_max_scan`) over all sequences and each width class's
    profiles, and the TPU kernel's score read after the last residue.
    """
    device = bank.device
    out = torch.empty((pack.S, bank.P), dtype=torch.float32, device=device)
    if pack.S == 0:
        return out
    step_fn = _viterbi_step if viterbi else _forward_step
    xs_all = pack.padded()
    lens_all = pack.lens.long()
    seqs = torch.arange(pack.S, device=device)
    for width, idx in bank.classes:
        W = min(width, bank.Mp)
        group = max(1, _PLAIN_CELLS // (pack.S * W))
        for c0 in range(0, idx.numel(), group):
            prof = idx[c0 : c0 + group].long()
            Pc = prof.numel()
            s = seqs.repeat_interleave(Pc)                     # row r: (s[r], p[r])
            p = prof.repeat(pack.S)
            R = s.numel()
            tr = bank.trans[:, p, :W]
            lens = lens_all[s]
            loop = pack.loops_exp[s][:, None]
            move = pack.moves_exp[s][:, None]
            xs = xs_all[s]
            zero = torch.zeros((R, W), dtype=torch.float32, device=device)
            col = zero[:, :1]
            shifted_tdd = _shift_right(tr[6], 0.0)
            M, I, D = zero, zero, zero
            N, B, J, C, ls = col + 1.0, move.clone(), col.clone(), col.clone(), col.clone()
            for i in range(int(lens.max())):
                alive = (i < lens)[:, None]
                e = bank.e_odds[xs[:, i], p, :W]
                Mn, In, Dn, Nn, Bn, Jn, Cn, total = step_fn(
                    M, I, D, N, B, J, C, e, tr, shifted_tdd, loop, move)
                inv = 1.0 / total
                M, I, D, N, B, J, C = (
                    torch.where(alive, new * inv, old)
                    for new, old in ((Mn, M), (In, I), (Dn, D), (Nn, N), (Bn, B), (Jn, J),
                                     (Cn, C)))
                ls = torch.where(alive, ls + torch.log(total), ls)
            c = C * move
            score = torch.log(torch.where(c >= _FLT_MIN, c, 0.0)) + ls
            out[:, prof] = score.view(pack.S, Pc)
    return out
