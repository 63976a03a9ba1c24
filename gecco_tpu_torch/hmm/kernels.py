"""Sequence pack, the F1 filters (kernels A and I), Viterbi pair scores
(kernel B) and dense all-pairs scores (kernel H).

Counterparts in ``gecco_tpu.hmm.kernels``:

* :class:`SeqPack` — ``SeqPack``: every residue uploaded once per
  search, here as one flat ``int8`` tensor with offsets, so a sequence
  of any length needs no padded row;
* :func:`ssv_filter` — ``SSVKernel.scores_packed`` and ``__call__``
  through ``Bucketed`` (``_pallas_ssv_quad``, ``_pallas_ssv`` and
  ``_pallas_ssv_pair``, one function): SSV scores of all (sequence,
  profile) pairs, the default F1 filter;
* :func:`msv_filter` — ``MSVKernel.scores_packed`` through ``Bucketed``
  (``_pallas_msv``): MSV scores of all pairs, the F1 filter of
  ``filter_stage="msv"`` (HMMER 3.0's multi-segment filter);
* :func:`pack_mask` — ``_jit_pack_mask`` in ``Bucketed.masks``: the F1
  Gumbel threshold, with or without the composition-bias null, as plain
  torch;
* :func:`viterbi_pairs` — ``PairForwardKernel.call_packed`` through
  ``PairBucketed.flat_packed`` (log-space Viterbi): scores of listed
  pairs for the F2 gate; with ``ranges``, ``PairForwardKernel(...,
  viterbi=True)(..., ranges=)`` (``_pallas_pair_fwd``): each pair scored
  over a residue window under the whole sequence's length model;
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

import functools
import math
from typing import Optional, Sequence

import numpy
import torch

from .. import _build
from ..profiling import TIMER
from .bank import NEG, TorchBank
from .profile import length_model, null1_score

__all__ = [
    "SeqPack", "ssv_filter", "ssv_filter_plain", "msv_filter", "msv_filter_plain", "msv_nodes",
    "msv_tile", "pack_mask", "residue_counts", "viterbi_pairs", "viterbi_pairs_plain", "pair_blocks",
    "pair_launches", "run_launches", "viterbi_launches", "dense_scores", "dense_scores_plain",
    "to_host",
]

LOG2 = math.log(2.0)
LOG_HALF = math.log(0.5)
#: smallest normal float32; kernel H flushes values below it to zero
_FLT_MIN = float(numpy.finfo(numpy.float32).tiny)
#: cells (rows x nodes) of one plane of the plain dense scorer
_PLAIN_CELLS = 1 << 22
#: most rows of one profile that a block of kernel B takes (its warps take
#: them in turn); small, so that a class of few pairs still fills the card
VITERBI_BLOCK_ROWS = 16
#: sequences of one profile that a block of kernel H takes at widths 128
#: to 1,024 (its warps take them in turn): the profile is staged once for
#: them
DENSE_TILE = 64
#: widest class in which kernel H runs a warp per pair; wider classes run
#: a block of the class's whole width per pair
DENSE_WARP_WIDTH = 1024
#: lanes of a warp that score one sequence in kernel I's width classes
#: (``msv.cu``'s ``MSV_LANES``; 32 where not listed): a warp scores 32 / G
#: sequences side by side
MSV_LANES = {128: 4, 256: 8, 512: 16}


def to_host(tensor: torch.Tensor) -> "numpy.ndarray":
    """``tensor`` read back as a numpy array: a point where the host waits
    for the device, counted as ``host_reads``."""
    TIMER.count("host_reads")
    return tensor.cpu().numpy()


def dense_nodes(bank: "TorchBank") -> "numpy.ndarray":
    """Nodes of a DP row that kernel H computes for each profile of
    ``bank``: 32 ceil(M / 32) to ``DENSE_WARP_WIDTH`` (each of a warp's 32
    lanes holds ceil(M / 32) nodes, ``dense.cu``'s ``dense_kernel``), the
    class's width above it."""
    lengths = bank.host.lengths.astype(numpy.int64)
    return numpy.where(bank.class_of <= DENSE_WARP_WIDTH, 32 * -(-lengths // 32), bank.class_of)


def msv_tile(width: int) -> int:
    """Sequences of one profile that a block of kernel I takes in the
    ``width`` class below 4,096 nodes, in the order of
    :meth:`SeqPack.by_length` (``msv.cu``'s ``MSV_TILE_OF``): 32, or one
    take of 32 / G sequences for each of its 8 warps."""
    return max(32, 8 * 32 // MSV_LANES.get(width, 32))


def msv_nodes(bank: "TorchBank") -> "numpy.ndarray":
    """Nodes of a DP row that kernel I computes for each profile of
    ``bank``: G ceil(M / G) for the class's G lanes a sequence (``msv.cu``:
    ceil(M / G) nodes a lane), but the class's whole width in the 2,048-node
    class, which runs one body."""
    lengths = bank.host.lengths.astype(numpy.int64)
    lanes = numpy.array([MSV_LANES.get(int(w), 32) for w in bank.class_of], dtype=numpy.int64)
    return numpy.where(bank.class_of == 2048, 2048, lanes * -(-lengths // lanes))


def residue_counts(sequences: Sequence["numpy.ndarray"]) -> "numpy.ndarray":
    """``[S, 20]`` int64 counts of each sequence's residues (codes 0-19;
    the degenerate codes from 20 up are not counted)."""
    lens = [len(x) for x in sequences]
    rows = numpy.repeat(numpy.arange(len(lens), dtype=numpy.int64), lens)
    codes = numpy.concatenate([numpy.minimum(x, 20) for x in sequences] or [rows])
    return numpy.bincount(rows * 21 + codes, minlength=21 * len(lens)).reshape(-1, 21)[:, :20]


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
        for i, x in enumerate(sequences):
            L = len(x)
            flat[offsets[i] : offsets[i] + L] = numpy.minimum(x, 20)
            loops_log[i], moves_log[i] = length_model(L)
            nullsc[i] = null1_score(L)
        counts = residue_counts(sequences).astype(numpy.float32)
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
        self._by_length = None

    def by_length(self) -> torch.Tensor:
        """``[S]`` int32 sequence indices, longest first (ties in index
        order): the order in which kernel I's blocks take the sequences."""
        if self._by_length is None:
            order = numpy.argsort(-self.lens_host.astype(numpy.int64), kind="stable")
            self._by_length = torch.as_tensor(order.astype(numpy.int32), device=self.device)
        return self._by_length

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
# kernels A and I: the F1 filters over every pair
# ---------------------------------------------------------------------------

def _launch_filter(fn_name: str, counter: str, pack: SeqPack, bank: TorchBank,
                   order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch filter kernel ``fn_name`` once per width class: ``[S, P]`` nats.
    ``order`` (kernel I's :meth:`SeqPack.by_length`) goes after the
    sequence count."""
    _check_pack_bank(pack, bank, log_space=True)
    _check(bank.tbm_log, torch.float32, "tbm", bank.device)
    extra = ()
    if order is not None:
        _check(order, torch.int32, "sequence order", bank.device)
        extra = (order.data_ptr(),)
    out = torch.empty((pack.S, bank.P), dtype=torch.float32, device=bank.device)
    if pack.S == 0:
        return out
    fn = getattr(_build.library(), fn_name)
    with torch.cuda.device(bank.device):
        stream = torch.cuda.current_stream(bank.device).cuda_stream
        for width, idx in bank.classes:
            _check(idx, torch.int32, "profile index", bank.device)
            code = fn(
                pack.xs.data_ptr(), pack.offsets.data_ptr(), pack.lens.data_ptr(),
                pack.loops_log.data_ptr(), pack.moves_log.data_ptr(), pack.S, *extra,
                bank.e_log.data_ptr(), bank.tbm_log.data_ptr(), idx.data_ptr(),
                int(idx.numel()), bank.lengths.data_ptr(), bank.P, bank.Mp, width,
                out.data_ptr(), stream,
            )
            _build.check(code, fn_name)
            TIMER.count(f"launch.{counter}")
    return out


def ssv_filter(pack: SeqPack, bank: TorchBank) -> torch.Tensor:
    """SSV filter scores (nats) of every pair, ``[S, P]`` on the device."""
    if _kernel_device(pack, bank) == "cpu":
        return ssv_filter_plain(pack, bank)
    return _launch_filter("gecco_ssv_filter", "ssv_filter", pack, bank)


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


def msv_filter(pack: SeqPack, bank: TorchBank) -> torch.Tensor:
    """MSV filter scores (nats) of every pair, ``[S, P]`` on the device."""
    if _kernel_device(pack, bank) == "cpu":
        return msv_filter_plain(pack, bank)
    return _launch_filter("gecco_msv_filter", "msv_filter", pack, bank, pack.by_length())


def msv_filter_plain(pack: SeqPack, bank: TorchBank) -> torch.Tensor:
    """Plain PyTorch MSV filter: the recurrence over ``[S, P, W]`` planes.

    The TPU kernel's log-space max-plus form, in its order of additions::

        Mn = e + max(shift(M), B + tbm)      # shift: node k-1, NEG into node 0
        E  = max_k Mn;  J = max(J + loop, E + log 1/2);  C likewise
        N  = N + loop;  B = max(N, J) + move
        score = C + move                     # after the last residue

    from ``M = NEG, N = 0, B = move, J = C = NEG``; an empty sequence
    scores ``NEG``.  (J and C are equal at every residue; kernel I keeps J
    alone.)
    """
    out = torch.full((pack.S, bank.P), NEG, dtype=torch.float32, device=bank.device)
    for prof, _J, C in msv_states_plain(pack, bank):
        out[:, prof] = C + pack.moves_log[:, None]
    out[pack.lens.long() == 0] = NEG
    return out


def msv_states_plain(pack: SeqPack, bank: TorchBank):
    """The plain MSV recurrence of :func:`msv_filter_plain`, each width
    class in turn: yields ``(profiles, J, C)``, the ``[S, Pc]`` J and C
    states after each sequence's last residue."""
    device = bank.device
    if pack.S == 0:
        return
    xs = pack.padded()
    lens = pack.lens.long()
    loop = pack.loops_log[:, None]
    move = pack.moves_log[:, None]
    for width, idx in bank.classes:
        W = min(width, bank.Mp)
        prof = idx.long()
        e = bank.e_log[:, prof, :W]                                  # [21, Pc, W]
        tbm = bank.tbm_log[prof][None, :]
        shape = (pack.S, len(prof))
        M = torch.full((*shape, W), NEG, dtype=torch.float32, device=device)
        first = M[..., :1].clone()
        N = torch.zeros((pack.S, 1), dtype=torch.float32, device=device)
        B = move.expand(shape).clone()
        J = torch.full(shape, NEG, dtype=torch.float32, device=device)
        C = J.clone()
        for i in range(xs.shape[1]):
            alive = (i < lens)[:, None]
            shifted = torch.cat([first, M[..., :-1]], dim=2)
            Mn = e[xs[:, i]] + torch.maximum(shifted, (B + tbm)[..., None])
            Elm = Mn.amax(dim=2) + LOG_HALF
            Jn = torch.maximum(J + loop, Elm)
            Cn = torch.maximum(C + loop, Elm)
            Nn = N + loop
            Bn = torch.maximum(Nn, Jn) + move
            M = torch.where(alive[..., None], Mn, M)
            N, B, J, C = (torch.where(alive, a, b) for a, b in ((Nn, N), (Bn, B), (Jn, J), (Cn, C)))
        yield prof, J, C


def pack_mask(scores: torch.Tensor, pack: SeqPack, bank: TorchBank,
              F1: float, bias: bool = True) -> "numpy.ndarray":
    """F1 survivor matrix ``[S, P]`` (bool, host) from filter scores.

    ``pv <= F1`` rewritten as a per-pair score threshold (the Gumbel
    survival is monotone), against the null-1 score plus, with ``bias``,
    the composition filter null clipped at >= 0 — as
    ``gecco_tpu.hmm.kernels.Bucketed.masks``.
    """
    if F1 < 1e-13:  # below the exact branch's resolution: tail form
        y_thr = -math.log(F1)
    else:
        y_thr = -math.log(-math.log1p(-F1))
    host = bank.host
    thr = LOG2 * (host.msv_mu + y_thr / host.msv_lambda)
    null = pack.nullsc[:, None]
    if bias:
        delta = pack.counts @ bank.logratio
        null = null + torch.clamp(
            torch.logaddexp(torch.zeros_like(delta), delta) - LOG2, min=0.0)
    keep = scores >= null + torch.as_tensor(thr, device=bank.device)[None, :]
    return to_host(keep)


# ---------------------------------------------------------------------------
# pair lists (F2 / F3)
# ---------------------------------------------------------------------------

def launch_rows(fn_name: str, counter: str, pack: SeqPack, bank: TorchBank,
                seq: torch.Tensor, prof: torch.Tensor, width: int, *tail: torch.Tensor,
                log_space: bool, stride=None) -> None:
    """Launch kernel ``fn_name`` once over the rows ``(seq[r], prof[r])``.

    Every row kernel (B–G, J, K) takes the pack, the rows' ``int32``
    indices, the bank and ``width``; kernels D–G, J and K add ``stride``.
    ``tail`` are the kernel's own arguments, passed in order before the
    stream: tensors (their pointers), plain integers, or ``None`` for a
    null pointer.
    """
    _check_pack_bank(pack, bank, log_space)
    for name, t in (("row sequences", seq), ("row profiles", prof)):
        _check(t, torch.int32, name, bank.device)
    for t in tail:
        if isinstance(t, torch.Tensor) and (t.device != bank.device or not t.is_contiguous()):
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
            *[t.data_ptr() if isinstance(t, torch.Tensor) else t for t in tail], stream,
        )
    _build.check(code, fn_name)
    TIMER.count(f"launch.{counter}")


def check_ranges(pack: SeqPack, seq_idx, ranges):
    """Residue windows ``[n, 2]`` (0-based, half-open) of rows ``seq_idx``
    as host ``int64``, or ``None``; raises unless ``0 <= start <= end <=
    length`` in every row."""
    if ranges is None:
        return None
    seq_idx = numpy.asarray(seq_idx, dtype=numpy.int64)
    ranges = numpy.asarray(ranges, dtype=numpy.int64)
    if ranges.shape != (len(seq_idx), 2):
        raise ValueError(f"ranges must have shape ({len(seq_idx)}, 2)")
    if len(ranges) and ((ranges[:, 0] < 0).any() or (ranges[:, 0] > ranges[:, 1]).any()
                        or (ranges[:, 1] > pack.lens_host[seq_idx]).any()):
        raise ValueError("ranges must satisfy 0 <= start <= end <= length")
    return ranges


def pair_blocks(class_of, prof, rows_per_block: int):
    """The rows of a warp-per-pair launch, cut into blocks of one profile.

    ``class_of`` is each profile's width class and ``prof`` each row's
    profile (host arrays).  Returns ``(order, blocks)``: ``order`` sorts the
    rows by width class, then profile, stably (a radix sort for banks of
    up to 65,536 profiles), and ``blocks`` (``[n_blocks, 2]`` int32) gives
    each block's first row in that order and its row count, at most
    ``rows_per_block`` rows of one profile (an int, or a dict giving each
    width class its own).  ``out[order] = scores`` restores the input
    order.
    """
    class_of = numpy.asarray(class_of)
    rank = numpy.empty(len(class_of), dtype=numpy.int64)
    rank[numpy.argsort(class_of, kind="stable")] = numpy.arange(len(class_of))
    key = rank[numpy.asarray(prof, dtype=numpy.int64)]
    key = key.astype(numpy.min_scalar_type(max(len(class_of) - 1, 0)))
    order = numpy.argsort(key, kind="stable")
    k = key[order]
    run_first = numpy.flatnonzero(numpy.concatenate(([True], k[1:] != k[:-1])))
    run_end = numpy.concatenate((run_first[1:], [len(k)]))
    if isinstance(rows_per_block, dict):   # each run's cap, from its profile's class
        widths = numpy.array(sorted(rows_per_block))
        caps = numpy.array([rows_per_block[w] for w in widths], dtype=numpy.int64)
        run_class = class_of[numpy.asarray(prof, dtype=numpy.int64)[order[run_first]]]
        cap = caps[numpy.searchsorted(widths, run_class)]
    else:
        cap = numpy.full(len(run_first), rows_per_block, dtype=numpy.int64)
    per_run = -(-(run_end - run_first) // cap)
    run = numpy.repeat(numpy.arange(len(run_first)), per_run)
    within = numpy.arange(len(run)) - numpy.repeat(numpy.cumsum(per_run) - per_run, per_run)
    first = run_first[run] + cap[run] * within
    count = numpy.minimum(cap[run], run_end[run] - first)
    return order, numpy.stack([first, count], 1).astype(numpy.int32)


def pair_launches(fn_name: str, counter: str, pack: SeqPack, bank: TorchBank,
                  seq_idx, prof_idx, log_space: bool, ranges=None, rows_per_block: int = 0):
    """A pair kernel's launches over these pairs, prepared on the device.

    Returns ``(launches, finish)``: ``launches`` maps each width class of
    the pairs to a function that launches the kernel once over that
    class's rows, and ``finish()`` returns the scores in input order once
    every class has run.  ``ranges`` (host, checked here before the
    upload) gives each pair a residue window; without it the kernel takes
    null window pointers and scores whole sequences.  With
    ``rows_per_block`` the rows go in the order of :func:`pair_blocks` and
    each launch also takes its class's block table and block count before
    the windows; without it they are ordered by width class alone.
    """
    _check_pack_bank(pack, bank, log_space)
    seq_idx = numpy.asarray(seq_idx, dtype=numpy.int64)
    prof_idx = numpy.asarray(prof_idx, dtype=numpy.int64)
    n = len(seq_idx)
    out = torch.empty(n, dtype=torch.float32, device=bank.device)
    if n == 0:
        return {}, lambda: out
    if seq_idx.min() < 0 or seq_idx.max() >= pack.S:
        raise IndexError("pair sequence index out of range")
    if prof_idx.min() < 0 or prof_idx.max() >= bank.P:
        raise IndexError("pair profile index out of range")
    ranges = check_ranges(pack, seq_idx, ranges)
    width = bank.class_of[prof_idx]
    if rows_per_block:
        order, blocks = pair_blocks(bank.class_of, prof_idx, rows_per_block)
    else:
        order = numpy.argsort(width, kind="stable")
    seq_t = torch.as_tensor(seq_idx[order].astype(numpy.int32), device=bank.device)
    prof_t = torch.as_tensor(prof_idx[order].astype(numpy.int32), device=bank.device)
    if ranges is None:
        starts = ends = None
    else:
        starts, ends = (
            torch.as_tensor(numpy.ascontiguousarray(ranges[order, k], dtype=numpy.int32),
                            device=bank.device) for k in (0, 1))
    scores = torch.empty(n, dtype=torch.float32, device=bank.device)
    launches = {}
    bounds = numpy.flatnonzero(numpy.diff(width[order])) + 1
    for a, b in zip(numpy.concatenate(([0], bounds)), numpy.concatenate((bounds, [n]))):
        table = ()
        if rows_per_block:   # the class's blocks, their first rows counted from a
            lo, hi = numpy.searchsorted(blocks[:, 0], [a, b])
            mine = blocks[lo:hi].copy()
            mine[:, 0] -= a
            table = (torch.as_tensor(mine, device=bank.device), len(mine))
        window = (None, None) if ranges is None else (starts[a:b], ends[a:b])
        w = int(width[order[a]])
        launches[w] = functools.partial(
            launch_rows, fn_name, counter, pack, bank, seq_t[a:b], prof_t[a:b], w, *table,
            *window, scores[a:b], log_space=log_space)
    order_t = torch.as_tensor(order, device=bank.device)

    def finish() -> torch.Tensor:
        out[order_t] = scores
        return out

    return launches, finish


def run_launches(launches, finish) -> torch.Tensor:
    """Run the launches of :func:`pair_launches`; scores in input order."""
    for launch in launches.values():
        launch()
    return finish()


def window_rows(pack: SeqPack, s: torch.Tensor, ranges: torch.Tensor):
    """Plain-path residues of rows ``s``: ``(xs [n, Lmax], lens [n])``, each
    row cut to its window where ``ranges`` (``[n, 2]``, on the device) is given."""
    xs = pack.padded()[s]
    lens = pack.lens.long()[s]
    if ranges is None:
        return xs, lens
    start, end = ranges[:, 0], ranges[:, 1]
    pos = start[:, None] + torch.arange(xs.shape[1], device=xs.device)[None, :]
    return torch.gather(xs, 1, pos.clamp(max=xs.shape[1] - 1)), end - start


def pair_groups(bank: TorchBank, seq_idx, prof_idx, chunk: int):
    """Plain-path batches: ``(positions, seq, prof, width)`` per class chunk;
    ``positions`` index the input pairs."""
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

def viterbi_pairs(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx,
                  ranges=None) -> torch.Tensor:
    """Viterbi scores (nats) of pairs ``(seq_idx[r], prof_idx[r])``, ``[n]``.

    ``ranges`` (``[n, 2]`` host integers, 0-based half-open, ``0 <= start
    <= end <= length``) scores residues ``x[start:end]`` of each pair
    under the whole sequence's length model, as ``_pallas_pair_fwd`` does
    with ``ranges``; an empty window scores −inf (what the TPU kernel's
    ``log(0 + 1e-38)`` gives where the subnormal is flushed).
    """
    if _kernel_device(pack, bank) == "cpu":
        return viterbi_pairs_plain(pack, bank, seq_idx, prof_idx, ranges=ranges)
    return run_launches(*viterbi_launches(pack, bank, seq_idx, prof_idx, ranges=ranges))


def viterbi_launches(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx, ranges=None):
    """Kernel B's launches over these pairs, one per width class, prepared
    on the device (:func:`pair_launches`); CUDA tensors only."""
    return pair_launches("gecco_viterbi_pairs", "viterbi_pairs", pack, bank,
                         seq_idx, prof_idx, log_space=True, ranges=ranges,
                         rows_per_block=VITERBI_BLOCK_ROWS)


def viterbi_pairs_plain(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx,
                        chunk: int = 4096, ranges=None) -> torch.Tensor:
    """Plain PyTorch log-space Viterbi over ``[pairs, W]`` planes.

    The delete chain is the exact prefix max (``torch.cummax``) of the
    factored form ``D_j = S_{j-1} + max_{i<j}(M_i + log tmd_i − S_i)``.
    """
    device = bank.device
    out = torch.empty(len(seq_idx), dtype=torch.float32, device=device)
    ranges = check_ranges(pack, seq_idx, ranges)
    if ranges is not None:
        ranges = torch.as_tensor(ranges, device=device)
    for pos, s, p, W in pair_groups(bank, seq_idx, prof_idx, chunk):
        R = len(pos)
        tmm, tim, tdm, tmi, tii, tmdS, Sm1, bm = bank.trans_log[:, p, :W]
        xs, lens = window_rows(pack, s, None if ranges is None else ranges[pos])
        loop = pack.loops_log[s][:, None]
        move = pack.moves_log[s][:, None]
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
        score = (C + move)[:, 0]
        out[pos] = score if ranges is None else torch.where(lens > 0, score, -math.inf)
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
                int(viterbi), DENSE_TILE, out.data_ptr(), stream,
            )
            _build.check(code, "gecco_dense_scores")
            TIMER.count("launch.dense_scores")
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
