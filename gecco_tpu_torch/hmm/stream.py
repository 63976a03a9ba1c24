"""Forward rescore (kernel C) and domain definition (kernels D–G).

Counterpart of ``gecco_tpu.hmm.stream``:

* :func:`forward_pairs` — ``StreamScores.flat_packed`` with
  ``viterbi=False``: Forward scores of listed pairs, the F3 rescore;
* :func:`posterior_fwd` (kernel D, ``_stream_fwd``) and
  :func:`posterior_bwd` (kernel E, ``_stream_bwd``): per residue of each
  pair, the Forward trajectories of the special states and, from the
  Backward pass, the match occupancy ``mocc`` and begin posterior ``pB``;
* :func:`envelopes` — ``_jit_envelopes``: regions and envelopes from
  ``mocc`` and ``pB``, plain PyTorch on the device (XLA glue in JAX);
* :func:`align_bwd` (kernel F, ``_stream_align_bwd``): the Backward
  match/insert planes of each envelope row, bfloat16;
* :func:`align_fwd` (kernel G, ``_stream_align_fwd``): posteriors, the
  envelope Forward rescore, optimal-accuracy endpoints and the null2
  log-ratios of each envelope row;
* :class:`StreamDomains` — ``StreamDomains``: domain definition of
  candidate pairs through D–G, assembled into ``DomainHit`` on the host.

The JAX package pre-gathers each pair's emission stream into a padded
``[cells, Lps, C, Mp]`` tensor; the kernels here read emissions by
residue index from the bank tensor.  Per-row outputs are padded per call
to its longest row (``stride``) and are zero past each row's length.  A
call takes rows of any width class: kernels D–G make one launch per class
up to 1,024 nodes (a warp or a block a row, blocks of one profile's rows)
and one for the rows above, each row read and written in place
(``StreamDomains`` calls one class at a time).  Each kernel wrapper takes
the plain version for CPU tensors and launches its kernel (``csrc/``) or
raises for CUDA tensors.
"""

import functools
import math
from typing import Dict, List, Sequence, Tuple

import numpy
import torch

from . import engine
from .bank import NEG, TorchBank
from .engine import DomainHit, exp_surv
from .kernels import (
    DENSE_WARP_WIDTH, SeqPack, _check, _forward_step, _kernel_device, _shift_right, check_ranges,
    launch_rows, pair_blocks, pair_groups, pair_launches, run_launches, to_host, window_rows,
)
from .profile import length_model, null1_score

__all__ = [
    "forward_pairs", "forward_pairs_plain", "forward_launches",
    "posterior_fwd", "posterior_fwd_plain", "posterior_fwd_launches", "posterior_bwd",
    "posterior_bwd_plain", "posterior_bwd_launches", "envelopes", "align_bwd",
    "align_bwd_plain", "align_bwd_launches", "align_fwd", "align_fwd_plain",
    "align_fwd_launches",
    "DeviceDomains", "StreamDomains", "assemble_domains",
]

LOG2 = math.log(2.0)
TINY = 1e-38

# as ``gecco_tpu.hmm.stream``
_MAX_LPS = 4096   # streams beyond this fall back to the host engine
#: fixed device slots: regions per pair, envelopes per region
_N_REGIONS = 8
_N_ENVS = 4
#: most rows of one profile that a block of kernel C takes at widths 128
#: to 1,024 (its warps take them in turn; ``hmm.kernels.pair_blocks``)
FORWARD_BLOCK_ROWS = 16
#: most rows of one profile that a block of kernels D, E, F and J takes in
#: each width class, one a warp (``stream_fwd.cu``'s ``D_WARPS``,
#: ``stream_bwd.cu``'s ``E_WARPS``, ``align_bwd.cu``'s ``F_WARPS``,
#: ``pair_posterior.cu``'s ``J_WARPS``): a launch of few rows a profile
#: then runs every row side by side.  The classes above 1,024 nodes take a
#: block a row.
DOMAIN_BLOCK_ROWS = {128: 4, 256: 4, 512: 8, 1024: 8, 2048: 1, 4096: 1}
#: the same for kernels G and K (``align_fwd.cu``'s ``G_WARPS``,
#: ``pair_align.cu``'s ``K_WARPS``), which take a block a row from 512
#: nodes up
ALIGN_FWD_BLOCK_ROWS = {128: 4, 256: 4, 512: 1, 1024: 1, 2048: 1, 4096: 1}


def forward_pairs(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx,
                  ranges=None) -> torch.Tensor:
    """Forward scores (nats) of pairs ``(seq_idx[r], prof_idx[r])``, ``[n]``.

    ``ranges`` (``[n, 2]`` host integers, 0-based half-open, ``0 <= start
    <= end <= length``) scores residues ``x[start:end]`` of each pair
    under the whole sequence's length model — ``PairForwardKernel(...,
    ranges=)``, the envelope-window rescore of ``_pallas_pair_fwd``, not
    kernel G's envelope Forward, which takes the envelope's own length
    model.  An empty window scores −inf (what the TPU kernel's ``log(0 +
    1e-38)`` gives where the subnormal is flushed); an empty sequence
    without ``ranges`` scores −1e30.
    """
    if _kernel_device(pack, bank) == "cpu":
        return forward_pairs_plain(pack, bank, seq_idx, prof_idx, ranges=ranges)
    return run_launches(*forward_launches(pack, bank, seq_idx, prof_idx, ranges=ranges))


def forward_launches(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx, ranges=None):
    """Kernel C's launches over these pairs, one per width class, prepared
    on the device (``hmm.kernels.pair_launches``); CUDA tensors only."""
    return pair_launches("gecco_forward_pairs", "forward_pairs", pack, bank,
                         seq_idx, prof_idx, log_space=False, ranges=ranges,
                         rows_per_block=FORWARD_BLOCK_ROWS)


def _affine_scan_rev(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``b_k + a_k d_{k+1}`` scanned from the right (doubling, full depth)."""
    width = a.shape[1]
    shift = 1
    while shift < width:
        next_b = torch.cat([b[:, shift:], torch.zeros_like(b[:, :shift])], 1)
        next_a = torch.cat([a[:, shift:], torch.ones_like(a[:, :shift])], 1)
        b = b + a * next_b
        a = a * next_a
        shift *= 2
    return b


def _shift_left(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)


def forward_pairs_plain(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx,
                        chunk: int = 4096, ranges=None) -> torch.Tensor:
    """Plain PyTorch Forward (probability space, rescaled every residue).

    The delete chain ``D_k = D_{k-1} tdd_{k-1} + M_{k-1} tmd_{k-1}`` is an
    exact doubling scan over the whole node axis.
    """
    device = bank.device
    out = torch.empty(len(seq_idx), dtype=torch.float32, device=device)
    ranges = check_ranges(pack, seq_idx, ranges)
    if ranges is not None:
        ranges = torch.as_tensor(ranges, device=device)
    for pos, s, p, W in pair_groups(bank, seq_idx, prof_idx, chunk):
        R = len(pos)
        tr = bank.trans[:, p, :W]
        xs, lens = window_rows(pack, s, None if ranges is None else ranges[pos])
        loop = pack.loops_exp[s][:, None]
        move = pack.moves_exp[s][:, None]
        zero = torch.zeros((R, W), dtype=torch.float32, device=device)
        col = zero[:, :1]
        shifted_tdd = _shift_right(tr[6], 0.0)
        M, I, D = zero, zero, zero
        N = col + 1.0
        B = move.clone()
        J, C, ls = col.clone(), col.clone(), col.clone()
        score = torch.full((R, 1), NEG if ranges is None else -math.inf,
                           dtype=torch.float32, device=device)
        for i in range(int(lens.max()) if R else 0):
            alive = (i < lens)[:, None]
            e = bank.e_odds[xs[:, i], p, :W]
            Mn, In, Dn, Nn, Bn, Jn, Cn, total = _forward_step(
                M, I, D, N, B, J, C, e, tr, shifted_tdd, loop, move)
            inv = 1.0 / total
            ls_n = ls + torch.log(total)
            done = (i == lens - 1)[:, None]
            score = torch.where(done, torch.log(Cn * inv * move + 1e-38) + ls_n, score)
            M, I, D, N, B, J, C = (
                torch.where(alive, new * inv, old)
                for new, old in ((Mn, M), (In, I), (Dn, D), (Nn, N), (Bn, B), (Jn, J), (Cn, C)))
            ls = torch.where(alive, ls_n, ls)
        out[pos] = score[:, 0]
    return out


# ---------------------------------------------------------------------------
# rows of a domain-definition launch
# ---------------------------------------------------------------------------

class _Rows:
    """The (sequence, profile) rows of one call of kernels D–G, J or K.

    ``width`` is the call's node width, the widest class among the rows
    (kernels J and K launch at it, F's planes take it); ``stride`` its
    residue axis, the longest row (at least 1).  The
    plain versions compute over ``min(width, Mp)`` nodes (the bank holds
    no more; nodes past a model's length are zero either way).
    """

    def __init__(self, pack: SeqPack, bank: TorchBank, seq_idx, prof_idx):
        if pack.device != bank.device:
            raise ValueError(f"pack on {pack.device}, bank on {bank.device}")
        seq_idx = numpy.asarray(seq_idx, dtype=numpy.int64)
        prof_idx = numpy.asarray(prof_idx, dtype=numpy.int64)
        if seq_idx.shape != prof_idx.shape or seq_idx.ndim != 1:
            raise ValueError("seq_idx and prof_idx must be 1-D arrays of one length")
        if len(seq_idx) and (seq_idx.min() < 0 or seq_idx.max() >= pack.S):
            raise IndexError("row sequence index out of range")
        if len(prof_idx) and (prof_idx.min() < 0 or prof_idx.max() >= bank.P):
            raise IndexError("row profile index out of range")
        self.pack, self.bank = pack, bank
        self.seq_host, self.prof_host = seq_idx, prof_idx
        self.n = len(seq_idx)
        self.lens_host = pack.lens_host[seq_idx].astype(numpy.int64)
        self.width = int(bank.class_of[prof_idx].max()) if self.n else 128
        self.stride = max(1, int(self.lens_host.max(initial=0)))

    @functools.cached_property
    def seq(self) -> torch.Tensor:
        """The rows' sequence indices on the device (uploaded on first use)."""
        return torch.as_tensor(self.seq_host, device=self.bank.device)

    @functools.cached_property
    def prof(self) -> torch.Tensor:
        """The rows' profile indices on the device (uploaded on first use)."""
        return torch.as_tensor(self.prof_host, device=self.bank.device)

    # -- kernel launch ------------------------------------------------------

    def launches(self, fn_name: str, counter: str, *tail,
                 rows_per_block=DOMAIN_BLOCK_ROWS) -> Dict[int, functools.partial]:
        """Kernel ``fn_name``'s launches over the rows (kernels D–G, J, K),
        prepared on the device and keyed by the width each runs at: one
        per width class up to ``DENSE_WARP_WIDTH`` nodes, its rows cut into
        blocks of at most ``rows_per_block`` rows of one profile
        (:func:`~.kernels.pair_blocks`), and one at the launch's width for
        the rows of the classes above (a block a row).  Each takes the
        rows in that order, its block table and count, each row's output
        slot (its index here) and the number of slots, then ``tail``, so
        that the kernel reads and writes every row in place.  The schedule
        goes to the device in one copy."""
        n, bank = self.n, self.bank
        if n == 0:
            return {}
        order, blocks = pair_blocks(bank.class_of, self.prof_host, rows_per_block)
        key = numpy.minimum(bank.class_of[self.prof_host[order]], 2 * DENSE_WARP_WIDTH)
        bounds = numpy.flatnonzero(numpy.diff(key)) + 1
        starts, ends = numpy.concatenate(([0], bounds)), numpy.concatenate((bounds, [n]))
        first = blocks[:, 0].copy()
        blocks[:, 0] -= starts[numpy.searchsorted(starts, first, side="right") - 1]
        packed = torch.as_tensor(numpy.concatenate(
            [self.seq_host[order], self.prof_host[order], order, blocks.ravel()]
        ).astype(numpy.int32), device=bank.device)
        seq_t, prof_t, slot_t = packed[:n], packed[n : 2 * n], packed[2 * n : 3 * n]
        table_t = packed[3 * n :].view(-1, 2)
        launches = {}
        for a, b in zip(starts, ends):
            width, table = int(key[a]), (None, 0)
            if width <= DENSE_WARP_WIDTH:   # the class's blocks, first rows counted from a
                lo, hi = numpy.searchsorted(first, [a, b])
                table = (table_t[lo:hi], int(hi - lo))
            else:
                width = self.width
            launches[width] = functools.partial(
                launch_rows, fn_name, counter, self.pack, bank, seq_t[a:b], prof_t[a:b], width,
                *table, slot_t[a:b], self.n, *tail, log_space=False, stride=self.stride)
        return launches

    # -- plain versions -----------------------------------------------------

    def plain(self):
        """Tensors of the plain versions (``W = min(width, Mp)`` nodes)."""
        pack, bank = self.pack, self.bank
        W = min(self.width, bank.Mp)
        s, p = self.seq, self.prof
        tr = bank.trans[:, p, :W]
        return dict(
            W=W, tr=tr, nm=bank.e_odds[20, p, :W], xs=pack.padded()[s],
            lens=pack.lens.long()[s], loop=pack.loops_exp[s][:, None],
            move=pack.moves_exp[s][:, None], shifted_tdd=_shift_right(tr[6], 0.0),
        )

    def emissions(self, xs: torch.Tensor, i: int, W: int) -> torch.Tensor:
        """``[n, W]`` emission odds of each row's residue ``i`` (clamped to the pack)."""
        i = min(i, xs.shape[1] - 1)
        return self.bank.e_odds[xs[:, i], self.prof, :W]

    def zeros(self, *shape, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.bank.device)


# ---------------------------------------------------------------------------
# kernel D: posterior Forward with special-state trajectories
# ---------------------------------------------------------------------------

def posterior_fwd(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward trajectories of rows ``(seq_idx[r], prof_idx[r])``.

    Returns ``traj [5, n, stride]`` (rescaled ``N, B, J, C`` after each
    residue and the running log scale) and the Forward ``score [n]``
    (nats; −1e30 for an empty sequence).
    """
    if _kernel_device(pack, bank) == "cpu":
        return posterior_fwd_plain(pack, bank, seq_idx, prof_idx)
    launches, out = posterior_fwd_launches(pack, bank, seq_idx, prof_idx)
    return run_launches(launches, lambda: out)


def posterior_fwd_launches(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx):
    """Kernel D's launches over these rows (:meth:`_Rows.launches`) and the
    ``(traj, score)`` they fill once every one has run."""
    rows = _Rows(pack, bank, seq_idx, prof_idx)
    traj = torch.empty((5, rows.n, rows.stride), dtype=torch.float32, device=bank.device)
    score = torch.empty(rows.n, dtype=torch.float32, device=bank.device)
    return rows.launches("gecco_posterior_fwd", "posterior_fwd", traj, score), (traj, score)


def posterior_fwd_plain(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch kernel D: the Forward of :func:`forward_pairs_plain` plus trajectories."""
    traj, score = forward_trajectories(_Rows(pack, bank, seq_idx, prof_idx))
    return traj[:5], score


def forward_trajectories(rows: "_Rows") -> Tuple[torch.Tensor, torch.Tensor]:
    """``traj [6, n, stride]`` — the rescaled ``N, B, J, C`` after each
    residue, the running log scale and the rescaled ``E`` (kernel J
    records it; kernel D's output is the first five) — and the Forward
    ``score [n]``."""
    v = rows.plain()
    R, W, lens, loop, move = rows.n, v["W"], v["lens"], v["loop"], v["move"]
    traj = rows.zeros(6, R, rows.stride)
    zero = rows.zeros(R, W)
    col = zero[:, :1]
    M, I, D = zero, zero, zero
    N, B, J, C, ls = col + 1.0, move.clone(), col.clone(), col.clone(), col.clone()
    score = torch.full((R, 1), NEG, dtype=torch.float32, device=rows.bank.device)
    for i in range(int(lens.max()) if R else 0):
        alive = (i < lens)[:, None]
        Mn, In, Dn, Nn, Bn, Jn, Cn, total = _forward_step(
            M, I, D, N, B, J, C, rows.emissions(v["xs"], i, W), v["tr"],
            v["shifted_tdd"], loop, move)
        inv = 1.0 / total
        ls_n = ls + torch.log(total)
        E = (Mn + Dn).sum(dim=1, keepdim=True)       # as _forward_step sums it
        for slot, value in enumerate((Nn * inv, Bn * inv, Jn * inv, Cn * inv, ls_n, E * inv)):
            traj[slot, :, i] = torch.where(alive, value, 0.0)[:, 0]
        done = (i == lens - 1)[:, None]
        score = torch.where(done, torch.log(Cn * inv * move + 1e-38) + ls_n, score)
        M, I, D, N, B, J, C = (
            torch.where(alive, new * inv, old)
            for new, old in ((Mn, M), (In, I), (Dn, D), (Nn, N), (Bn, B), (Jn, J), (Cn, C)))
        ls = torch.where(alive, ls_n, ls)
    return traj, score[:, 0]


# ---------------------------------------------------------------------------
# the Backward recurrence shared by kernels E and F
# ---------------------------------------------------------------------------

def _backward(rows: _Rows, v):
    """Yield ``(o, alive, init, bM, bI, bN, bB, bJ, bC, ls)`` from the last residue down.

    The values are the rescaled Backward states of residue ``o`` and the
    log scale; at ``o = L-1`` they are the initial row (``init``), as
    ``stream.py:266-330`` emits them.  Rows past their length keep their
    carries (``alive`` is False there).
    """
    tmm, tim, tdm, tmi, tii, tmd, tdd, bm = v["tr"]
    nm, lens, loop, move, W = v["nm"], v["lens"], v["loop"], v["move"], v["W"]
    bE0 = move * 0.5
    binit = nm * bE0 + tmd * _shift_left(_affine_scan_rev(tdd, nm * bE0))
    zero = rows.zeros(rows.n, W)
    col = zero[:, :1]
    bM, bI = zero, zero
    bN, bJ, bC, ls = col, col, col, col
    for o in reversed(range(rows.stride)):
        alive = (o < lens)[:, None]
        init = (o == lens - 1)[:, None]
        e_next = rows.emissions(v["xs"], o + 1, W)
        q = _shift_left(e_next * bM)
        bBn = (bm * e_next * bM).sum(dim=1, keepdim=True)
        bJn = loop * bJ + move * bBn
        bCn = loop * bC
        bNn = loop * bN + move * bBn
        bEn = 0.5 * bJn + 0.5 * bCn
        bIn = tim * q + tii * bI
        bDn = _affine_scan_rev(tdd, nm * bEn + tdm * q)
        bMn = nm * bEn + tmm * q + tmi * bI + tmd * _shift_left(bDn)
        scale = bNn + bJn + bCn + bBn + 1e-30
        inv = 1.0 / scale
        ls_n = ls + torch.log(scale)
        bM_e = torch.where(init, binit, bMn * inv)
        bI_e = torch.where(init, 0.0, bIn * inv)
        bN_e, bB_e, bJ_e = (torch.where(init, 0.0, x * inv) for x in (bNn, bBn, bJn))
        bC_e = torch.where(init, move, bCn * inv)
        ls_e = torch.where(init, 0.0, ls_n)
        yield o, alive, init, bM_e, bI_e, bN_e, bB_e, bJ_e, bC_e, ls_e
        sel = alive & ~init
        bM = torch.where(init, binit, torch.where(sel, bMn * inv, bM))
        bI = torch.where(init, 0.0, torch.where(sel, bIn * inv, bI))
        bN = torch.where(init, 0.0, torch.where(sel, bNn * inv, bN))
        bJ = torch.where(init, 0.0, torch.where(sel, bJn * inv, bJ))
        bC = torch.where(init, move, torch.where(sel, bCn * inv, bC))
        ls = torch.where(init, 0.0, torch.where(sel, ls_n, ls))


# ---------------------------------------------------------------------------
# kernel E: posterior Backward -> mocc, pB
# ---------------------------------------------------------------------------

def posterior_bwd(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx,
                  traj: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """``post [2, n, stride]``: match occupancy ``mocc`` and begin posterior ``pB``.

    ``traj`` and ``score`` are :func:`posterior_fwd`'s for the same rows.
    ``mocc = clip(1 − ppN − ppJ − ppC, 0, 1)`` per residue; both are zero
    past each row's length.
    """
    if _kernel_device(pack, bank) == "cpu":
        return posterior_bwd_plain(pack, bank, seq_idx, prof_idx, traj, score)
    launches, post = posterior_bwd_launches(pack, bank, seq_idx, prof_idx, traj, score)
    return run_launches(launches, lambda: post)


def posterior_bwd_launches(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx,
                           traj: torch.Tensor, score: torch.Tensor):
    """Kernel E's launches over these rows (:meth:`_Rows.launches`, reading
    ``traj`` and ``score`` at each row's slot) and the ``post`` they fill
    once every one has run."""
    rows = _Rows(pack, bank, seq_idx, prof_idx)
    _check_rows_tensor(traj, (5, rows.n, rows.stride), torch.float32, "traj")
    _check_rows_tensor(score, (rows.n,), torch.float32, "score")
    post = torch.empty((2, rows.n, rows.stride), dtype=torch.float32, device=bank.device)
    return rows.launches("gecco_posterior_bwd", "posterior_bwd", traj, score, post), post


def posterior_bwd_plain(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx,
                        traj: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch kernel E (``stream.py:278-330``)."""
    return backward_posteriors(_Rows(pack, bank, seq_idx, prof_idx), traj, score, 2)


def backward_posteriors(rows: "_Rows", traj: torch.Tensor, score: torch.Tensor,
                        n_post: int) -> torch.Tensor:
    """``post [n_post, n, stride]``: ``mocc``, ``pB`` and, with ``n_post =
    3``, the end posterior ``pE = fE bE exp(fls + bls − total)``, ``bE =
    (bJ + bC) / 2`` (``traj`` is then :func:`forward_trajectories`' six
    rows).  The forward values one residue back are read at ``o-1``
    directly, with ``N=1, J=C=0`` and log scale 0 before the first residue.
    """
    v = rows.plain()
    loop = v["loop"]
    post = rows.zeros(n_post, rows.n, rows.stride)
    total = score[:, None]
    fN, fB, fJ, fC, flog = traj[:5]
    one = torch.ones_like(loop)
    for o, alive, _init, _bM, _bI, bN, bB, bJ, bC, ls in _backward(rows, v):
        if o == 0:
            prev_N, prev_J, prev_C, prev_ls = one, one * 0.0, one * 0.0, one * 0.0
        else:
            prev_N, prev_J, prev_C, prev_ls = (
                t[:, o - 1 : o] for t in (fN, fJ, fC, flog))
        sc_prev = torch.exp(prev_ls + ls - total)
        sc_cur = torch.exp(flog[:, o : o + 1] + ls - total)
        ppN = prev_N * loop * bN * sc_prev
        ppJ = prev_J * loop * bJ * sc_prev
        ppC = prev_C * loop * bC * sc_prev
        mocc = torch.clamp(1.0 - (ppN + ppJ + ppC), 0.0, 1.0)
        pB = fB[:, o : o + 1] * bB * sc_cur
        post[0, :, o] = torch.where(alive, mocc, 0.0)[:, 0]
        post[1, :, o] = torch.where(alive, pB, 0.0)[:, 0]
        if n_post > 2:
            pE = traj[5][:, o : o + 1] * (0.5 * bJ + 0.5 * bC) * sc_cur
            post[2, :, o] = torch.where(alive, pE, 0.0)[:, 0]
    return post


def _check_rows_tensor(t: torch.Tensor, shape, dtype, name: str) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    _check(t, dtype, name, t.device)


# ---------------------------------------------------------------------------
# envelope finder (plain PyTorch on the device)
# ---------------------------------------------------------------------------

def envelopes(mocc: torch.Tensor, pb: torch.Tensor, lens: torch.Tensor):
    """Envelope slots of each row from ``mocc``, ``pb`` ``[n, Lp]``.

    Restates ``gecco_tpu.hmm.stream._jit_envelopes``: regions are maximal
    runs with ``mocc >= RT2`` whose peak reaches ``RT1``
    (``engine._find_regions``); a region with ``n = round(expected B)``
    begins is cut where the cumulative B mass crosses ``m + 0.5``
    (``engine._split_region``).  Returns ``(ienv, jenv, overflow)``:
    ``[n, 8 * 4]`` 1-based inclusive coordinates, slot ``(r, e)`` of 8
    regions of 4 envelopes at ``4 r + e``, invalid where ``jenv < ienv``; and
    per row whether the slots overflowed (more regions, or a region with
    more envelopes), which sends the row to the host engine.
    Scatter reductions over (row, slot) replace JAX's loop over slots.
    """
    n, Lp = mocc.shape
    device = mocc.device
    pos = torch.arange(Lp, device=device)[None, :].expand(n, Lp)
    vpos = pos < lens.long()[:, None]
    above = (mocc >= engine.RT2) & vpos
    prev = torch.cat([torch.zeros_like(above[:, :1]), above[:, :-1]], 1)
    rid = torch.cumsum((above & ~prev).long(), dim=1) * above
    btot = torch.cumsum(torch.where(vpos, pb, 0.0), dim=1)
    btot_prev = torch.cat([torch.zeros_like(btot[:, :1]), btot[:, :-1]], 1)
    overflow = rid.amax(dim=1) > _N_REGIONS
    # per region r = 1.._N_REGIONS (column r; column 0 collects the rest)
    region = torch.where(rid <= _N_REGIONS, rid, 0)
    cols = _N_REGIONS + 1

    def per_region(src, how, init):
        out = torch.full((n, cols), init, dtype=src.dtype, device=device)
        return out.scatter_reduce(1, region, src, reduce=how, include_self=True)

    peak = per_region(torch.where(above, mocc, 0.0), "amax", 0.0)
    big = Lp + 1
    sj = per_region(torch.where(above, pos, big), "amin", big).clamp(0, Lp - 1)
    ej = per_region(torch.where(above, pos, -1), "amax", -1).clamp(0, Lp - 1)
    base = torch.gather(btot_prev, 1, sj)
    n_r = torch.round(torch.gather(btot, 1, ej) - base).long()
    valid_r = (peak >= engine.RT1)
    valid_r[:, 0] = False
    overflow |= (valid_r & (n_r > _N_ENVS)).any(dim=1)
    # envelope of each position within its region
    cprev = btot_prev - torch.gather(base, 1, region)
    n_pos = torch.gather(n_r, 1, region)
    env = torch.minimum(torch.floor(cprev - 0.5).long().clamp(min=0),
                        (n_pos - 1).clamp(min=0))
    slots = _N_REGIONS * _N_ENVS
    keep = torch.gather(valid_r, 1, region) & (env < _N_ENVS)
    slot = torch.where(keep, (region - 1) * _N_ENVS + env, slots)
    ienv = torch.full((n, slots + 1), big, dtype=torch.long, device=device).scatter_reduce(
        1, slot, pos, reduce="amin", include_self=True)[:, :slots] + 1
    jenv = torch.full((n, slots + 1), -1, dtype=torch.long, device=device).scatter_reduce(
        1, slot, pos, reduce="amax", include_self=True)[:, :slots] + 1
    return ienv.to(torch.int32), jenv.to(torch.int32), overflow


# ---------------------------------------------------------------------------
# kernel F: alignment Backward planes
# ---------------------------------------------------------------------------

def align_bwd(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward planes of rows ``(seq_idx[r], prof_idx[r])``.

    Returns ``planes [2, n, stride, width]`` bfloat16 (rescaled match and
    insert Backward values per residue and node) and ``logs [4, n,
    stride]`` float32: the Backward log scale and ``log bN``, ``log bJ``,
    ``log bC`` (with the scale folded in).  Zero past each row's length.
    """
    if _kernel_device(pack, bank) == "cpu":
        return align_bwd_plain(pack, bank, seq_idx, prof_idx)
    launches, out = align_bwd_launches(pack, bank, seq_idx, prof_idx)
    return run_launches(launches, lambda: out)


def align_bwd_launches(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx):
    """Kernel F's launches over these rows (:meth:`_Rows.launches`; each
    also takes the planes' width) and the ``(planes, logs)`` they fill
    once every one has run."""
    rows = _Rows(pack, bank, seq_idx, prof_idx)
    planes = torch.empty((2, rows.n, rows.stride, rows.width), dtype=torch.bfloat16,
                         device=bank.device)
    logs = torch.empty((4, rows.n, rows.stride), dtype=torch.float32, device=bank.device)
    return rows.launches("gecco_align_bwd", "align_bwd", rows.width, planes, logs), (planes, logs)


def align_bwd_plain(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch kernel F (``stream.py:456-501``); planes rounded as ``astype(bfloat16)``."""
    rows = _Rows(pack, bank, seq_idx, prof_idx)
    v = rows.plain()
    W = v["W"]
    planes = rows.zeros(2, rows.n, rows.stride, rows.width, dtype=torch.bfloat16)
    logs = rows.zeros(4, rows.n, rows.stride)
    log_move = torch.log(v["move"])
    for o, alive, init, bM, bI, bN, _bB, bJ, bC, ls in _backward(rows, v):
        planes[0, :, o, :W] = torch.where(alive, bM, 0.0).to(torch.bfloat16)
        planes[1, :, o, :W] = torch.where(alive, bI, 0.0).to(torch.bfloat16)
        values = (
            ls,
            torch.where(init, NEG, torch.log(bN + TINY) + ls),
            torch.where(init, NEG, torch.log(bJ + TINY) + ls),
            torch.where(init, log_move, torch.log(bC + TINY) + ls),
        )
        for slot, value in enumerate(values):
            logs[slot, :, o] = torch.where(alive, value, 0.0)[:, 0]
    return planes, logs


# ---------------------------------------------------------------------------
# kernel G: alignment Forward, envelope rescore, optimal accuracy, null2
# ---------------------------------------------------------------------------

def align_fwd(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx,
              planes: torch.Tensor, logs: torch.Tensor, iv, jv,
              total: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score and align envelope ``[iv[r], jv[r]]`` (1-based, inclusive) of each row.

    ``iv`` and ``jv`` are host integers (a numpy array or a CPU tensor),
    checked against the rows' lengths before they are uploaded.
    ``planes`` and ``logs`` are :func:`align_bwd`'s for the same rows,
    ``total`` each row's Forward score (:func:`posterior_fwd`).  Returns
    ``out [n, 22]`` float32 — the envelope Forward score under the
    envelope's own length model, then the 21 null2 log-ratios — and
    ``coords [n, 4]`` int32: target from/to, HMM from/to of the
    optimal-accuracy alignment.
    """
    if _kernel_device(pack, bank) == "cpu":
        return align_fwd_plain(pack, bank, seq_idx, prof_idx, planes, logs, iv, jv, total)
    launches, out = align_fwd_launches(pack, bank, seq_idx, prof_idx, planes, logs, iv, jv,
                                       total)
    return run_launches(launches, lambda: out)


def align_fwd_launches(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx,
                       planes: torch.Tensor, logs: torch.Tensor, iv, jv, total: torch.Tensor):
    """Kernel G's launches over these envelope rows (:meth:`_Rows.launches`
    with blocks of ``ALIGN_FWD_BLOCK_ROWS``; each also takes the planes'
    width, and reads the planes, logs, envelope and total at each row's
    slot) and the ``(out, coords)`` they fill once every one has run."""
    rows = _Rows(pack, bank, seq_idx, prof_idx)
    iv, jv = _envelope_bounds(rows, iv, jv)
    _check_rows_tensor(planes, (2, rows.n, rows.stride, rows.width), torch.bfloat16, "planes")
    _check_rows_tensor(logs, (4, rows.n, rows.stride), torch.float32, "logs")
    _check_rows_tensor(total, (rows.n,), torch.float32, "total")
    out = torch.empty((rows.n, 22), dtype=torch.float32, device=bank.device)
    coords = torch.empty((rows.n, 4), dtype=torch.int32, device=bank.device)
    launches = rows.launches("gecco_align_fwd", "align_fwd", rows.width, planes, logs, iv, jv,
                             total, out, coords, rows_per_block=ALIGN_FWD_BLOCK_ROWS)
    return launches, (out, coords)


def _envelope_bounds(rows: _Rows, iv, jv) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host envelopes checked (``1 <= iv <= jv <= length``), as int32 on the device."""
    iv, jv = (numpy.asarray(a, dtype=numpy.int64) for a in (iv, jv))
    if iv.shape != (rows.n,) or jv.shape != (rows.n,):
        raise ValueError(f"iv and jv must have shape ({rows.n},)")
    if rows.n and ((iv < 1).any() or (jv < iv).any() or (jv > rows.lens_host).any()):
        raise ValueError("envelopes must satisfy 1 <= iv <= jv <= length")
    return tuple(torch.as_tensor(a.astype(numpy.int32), device=rows.bank.device)
                 for a in (iv, jv))


def align_fwd_plain(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx,
                    planes: torch.Tensor, logs: torch.Tensor, iv, jv,
                    total: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch kernel G (``stream.py:668-870``), up to the last envelope residue.

    Past ``jv`` nothing that G reports changes, so the loop stops at the
    rows' largest ``jv``.  The OA delete chain is JAX's doubling max-scan
    with start payloads: a farther node wins only if strictly greater.
    """
    rows = _Rows(pack, bank, seq_idx, prof_idx)
    iv, jv = _envelope_bounds(rows, iv, jv)
    v = rows.plain()
    R, W, lens, loop, move = rows.n, v["W"], v["lens"], v["loop"], v["move"]
    tr = v["tr"]
    tmm, tim, tdm, tmi, tii, tmd, tdd, bm = tr
    device = bank.device
    gate = [torch.where(t > 0, 0.0, NEG) for t in (tmm, tim, tdm, tmi, tii, tmd, tdd)]
    g_mm, g_im, g_dm, g_mi, g_ii, g_md, g_dd = gate
    node_neg = torch.where(v["nm"] > 0, 0.0, NEG)
    iv_f = iv.float()[:, None]
    jv_f = jv.float()[:, None]
    total = total[:, None]
    log_loop = torch.log(loop)
    Ld = torch.clamp(jv_f - iv_f + 1.0, min=1.0)
    eloop = Ld / (Ld + 3.0)
    emove = 3.0 / (Ld + 3.0)
    lane = torch.arange(W, device=device)[None, :].expand(R, W)
    zero = rows.zeros(R, W)
    col = zero[:, :1]
    negs = torch.full((R, W), NEG, dtype=torch.float32, device=device)
    none = torch.full((R, W), -1, dtype=torch.long, device=device)
    M, I, D = zero, zero, zero
    N, B, J, C, lsf = col + 1.0, move.clone(), col.clone(), col.clone(), col.clone()
    eM, eI, eD = zero, zero, zero
    eN, eB, eJ, eC, elog = col + 1.0, emove.clone(), col.clone(), col.clone(), col.clone()
    sM, sI, sD = negs, negs, negs
    siM, skM, siI, skI, siD, skD = none, none, none, none, none, none
    best = torch.full((R, 1), NEG, dtype=torch.float32, device=device)
    coords = torch.zeros((R, 4), dtype=torch.long, device=device)
    matocc, insocc, xocc = zero, zero, col.clone()
    bMp, bIp = planes[0], planes[1]
    blog, bNl, bJl, bCl = logs
    for i in range(int(jv.max()) if R else 0):
        i_f = float(i + 1)
        alive = (i_f <= lens)[:, None]
        in_env = (i_f >= iv_f) & (i_f <= jv_f)
        e = rows.emissions(v["xs"], i, W)

        # full-sequence Forward step and posteriors
        Mn, In, Dn, Nn, Bn, Jn, Cn, tot = _forward_step(
            M, I, D, N, B, J, C, e, tr, v["shifted_tdd"], loop, move)
        inv = 1.0 / tot
        lsf_n = lsf + torch.log(tot)
        pscale = torch.exp(lsf_n + blog[:, i : i + 1] - total)
        ppM = (Mn * inv) * bMp[:, i, :W].float() * pscale
        ppI = (In * inv) * bIp[:, i, :W].float() * pscale
        matocc = matocc + torch.where(in_env, ppM, 0.0)
        insocc = insocc + torch.where(in_env, ppI, 0.0)
        pp_x = [torch.exp(torch.log(x + TINY) + lsf + log_loop + bl[:, i : i + 1] - total)
                for x, bl in ((N, bNl), (J, bJl), (C, bCl))]
        xp = torch.clamp(pp_x[0] + pp_x[1] + pp_x[2], 0.0, 1.0)
        xocc = xocc + torch.where(in_env, xp, 0.0)

        # envelope Forward rescore
        eMn, eIn, eDn, eNn, eBn, eJn, eCn, etot = _forward_step(
            eM, eI, eD, eN, eB, eJ, eC, e, tr, v["shifted_tdd"], eloop, emove)
        einv = 1.0 / etot
        eM, eI, eD, eN, eB, eJ, eC = (
            torch.where(in_env, new * einv, old)
            for new, old in ((eMn, eM), (eIn, eI), (eDn, eD), (eNn, eN), (eBn, eB),
                             (eJn, eJ), (eCn, eC)))
        elog = torch.where(in_env, elog + torch.log(etot), elog)

        # optimal-accuracy DP with start payloads
        fromM = _shift_right(sM + g_mm, NEG)
        fromI = _shift_right(sI + g_im, NEG)
        fromD = _shift_right(sD + g_dm, NEG)
        pM = torch.maximum(fromM, torch.maximum(fromI, fromD))
        entry = pM <= 0.0
        useM = fromM >= pM
        useI = ~useM & (fromI >= pM)

        def pick(a, b, c):
            return torch.where(useM, _shift_right(a, -1),
                               torch.where(useI, _shift_right(b, -1), _shift_right(c, -1)))

        sMn = node_neg + ppM + torch.clamp(pM, min=0.0)
        siMn = torch.where(entry, i + 1, pick(siM, siI, siD))
        skMn = torch.where(entry, lane + 1, pick(skM, skI, skD))
        fromMi = sM + g_mi
        fromIi = sI + g_ii
        useMi = fromMi >= fromIi
        sIn = node_neg + ppI + torch.maximum(fromMi, fromIi)
        siIn = torch.where(useMi, siM, siI)
        skIn = torch.where(useMi, skM, skI)
        dsc = _shift_right(sMn + g_md, NEG)
        dsi = _shift_right(siMn, -1)
        dsk = _shift_right(skMn, -1)
        dgate = _shift_right(g_dd, NEG)
        shift = 1
        while shift < W:
            cand = _shift_right(dsc, NEG, shift) + dgate
            take = cand > dsc
            dsc = torch.where(take, cand, dsc)
            dsi = torch.where(take, _shift_right(dsi, -1, shift), dsi)
            dsk = torch.where(take, _shift_right(dsk, -1, shift), dsk)
            dgate = dgate + _shift_right(dgate, 0.0, shift)
            shift *= 2
        sM, sI, sD = (torch.where(in_env, new, old)
                      for new, old in ((sMn, sM), (sIn, sI), (dsc, sD)))
        siM, skM, siI, skI, siD, skD = (
            torch.where(in_env, new, old)
            for new, old in ((siMn, siM), (skMn, skM), (siIn, siI), (skIn, skI),
                             (dsi, siD), (dsk, skD)))
        rowmax = sM.amax(dim=1, keepdim=True)
        upd = in_env & (rowmax > best)
        k_end = torch.where(sM == rowmax, lane, W).amin(dim=1, keepdim=True)
        found = torch.cat([torch.gather(siM, 1, k_end), torch.full_like(k_end, i + 1),
                           torch.gather(skM, 1, k_end), k_end + 1], 1)
        best = torch.where(upd, rowmax, best)
        coords = torch.where(upd, found, coords)

        # full-sequence carries
        M, I, D, N, B, J, C = (
            torch.where(alive, new * inv, old)
            for new, old in ((Mn, M), (In, I), (Dn, D), (Nn, N), (Bn, B), (Jn, J), (Cn, C)))
        lsf = torch.where(alive, lsf_n, lsf)

    out = rows.zeros(R, 22)
    out[:, 0] = (torch.log(eC * emove + 1e-38) + elog)[:, 0]
    ins = insocc.sum(dim=1, keepdim=True)
    inv_tot = 1.0 / torch.clamp(matocc.sum(dim=1, keepdim=True) + ins + xocc, min=1e-30)
    eg = bank.e_odds[:21, rows.prof, :W]                            # [21, R, W]
    n2 = ((matocc[None] * eg).sum(dim=2) + ins[None, :, 0] + xocc[None, :, 0]) * inv_tot[None, :, 0]
    out[:, 1:] = torch.log(torch.clamp(n2, min=1e-300)).T
    return out, coords.to(torch.int32)


# ---------------------------------------------------------------------------
# domain definition of candidate pairs
# ---------------------------------------------------------------------------

_KERNELS = {
    "cuda": (posterior_fwd, posterior_bwd, align_bwd, align_fwd),
    "torch": (posterior_fwd_plain, posterior_bwd_plain, align_bwd_plain, align_fwd_plain),
}


def _budget_groups(rows, length, row_bytes: int, budget: int):
    """``rows`` sorted by ``length``, cut into launches of at most
    ``budget`` bytes: a launch pads each row to its longest, so it takes
    ``count × longest × row_bytes``.  A row over the budget alone is a
    launch of its own."""
    group: list = []
    for row in sorted(rows, key=length):
        if group and (len(group) + 1) * length(row) * row_bytes > budget:
            yield group
            group = []
        group.append(row)
    if group:
        yield group


class DeviceDomains:
    """Domain definition of (sequence, profile) pairs on one device, in
    two device stages that a subclass supplies.

    :meth:`define` runs, per width class and split into launches under
    :attr:`BYTES_BUDGET`, the posterior stage (:meth:`_posteriors`) and
    the envelope finder, makes one device-to-host copy of every class's
    envelopes, sends rows whose envelope slots overflow to the float64
    host engine, runs the alignment stage (:meth:`_align`) over the
    envelope rows, makes one more copy, and assembles the ``DomainHit``
    records on the host (:func:`assemble_domains`).  Pairs that
    :meth:`_on_device` refuses go to the host engine; :attr:`host_pairs`
    counts the pairs of the last :meth:`define` that did.
    """

    #: per-launch cap on the device memory a group of rows takes (bytes):
    #: the alignment stage's bfloat16 planes, or the posterior stage's
    #: outputs and the envelope finder's temporaries
    BYTES_BUDGET = 1 << 30
    #: bytes per row and residue of the posterior stage (7 float32 values,
    #: 8 with kernel J's trajectory scratch) and of the ~12 int64/float32
    #: ``[n, stride]`` temporaries of :func:`envelopes`
    POSTERIOR_BYTES = 128

    def __init__(self, bank: TorchBank, profiles, backend: str = "cuda"):
        if backend not in ("cuda", "torch"):
            raise ValueError(f"invalid backend: {backend!r}")
        self.bank = bank
        self.profiles = list(profiles)
        self.backend = backend
        self.host_pairs = 0

    def _host(self, sequences, s: int, p: int) -> List[DomainHit]:
        self.host_pairs += 1
        return engine.define_domains(self.profiles[p], sequences[s])

    def _on_device(self, length: int, width: int) -> bool:
        """Whether the device stages take a sequence of ``length`` residues
        against a profile of class ``width``."""
        return length <= _MAX_LPS

    def _posteriors(self, pack, s_idx, p_idx) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(score [n], mocc [n, stride], pB [n, stride])`` of the rows."""
        raise NotImplementedError

    def _align(self, pack, s_idx, p_idx, iv, jv,
               total: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(out [n, 22], coords [n, 4])`` of the envelope rows."""
        raise NotImplementedError

    def _plane_residues(self, sequences, row) -> int:
        """Residues of the planes the alignment stage keeps for envelope
        row ``(s, p, ienv, jenv, score)``."""
        raise NotImplementedError

    def define(self, sequences: Sequence["numpy.ndarray"], pairs,
               pack: SeqPack) -> Dict[Tuple[int, int], List[DomainHit]]:
        """Domains of each distinct pair ``(s, p)``, sorted by envelope;
        ``pack`` holds ``sequences`` on the bank's device."""
        bank = self.bank
        self.host_pairs = 0
        out: Dict[Tuple[int, int], List[DomainHit]] = {}
        by_class: Dict[int, List[Tuple[int, int]]] = {}
        for s, p in dict.fromkeys((int(s), int(p)) for s, p in pairs):
            out[(s, p)] = []                # a repeated pair reports once
            L = len(sequences[s])
            if L == 0:
                continue                    # no residues, no domains
            width = int(bank.class_of[p])
            if not self._on_device(L, width):
                out[(s, p)] = self._host(sequences, s, p)
                continue
            by_class.setdefault(width, []).append((s, p))
        if not by_class:
            return out

        def length(sp):
            return len(sequences[sp[0]])

        # posteriors and envelopes of every class, then one copy to the host
        groups = []
        fetch = []
        for _width, members in sorted(by_class.items()):
            for part in _budget_groups(members, length, self.POSTERIOR_BYTES,
                                       self.BYTES_BUDGET):
                s_idx = numpy.asarray([s for s, _ in part])
                p_idx = numpy.asarray([p for _, p in part])
                score, mocc, pb = self._posteriors(pack, s_idx, p_idx)
                lens = pack.lens[torch.as_tensor(s_idx, device=bank.device)]
                ienv, jenv, over = envelopes(mocc, pb, lens)
                fetch.append(torch.cat([ienv, jenv, over.to(torch.int32)[:, None],
                                        score.view(torch.int32)[:, None]], 1))
                groups.append(part)
        fetched = to_host(torch.cat(fetch))
        slots = _N_REGIONS * _N_ENVS

        # envelope rows; overflowing pairs go to the host engine
        env_rows: Dict[int, List[Tuple[int, int, int, int, float]]] = {}
        at = 0
        for members in groups:
            block = fetched[at : at + len(members)]
            at += len(members)
            scores = block[:, 2 * slots + 1].copy().view(numpy.float32)
            for r, (s, p) in enumerate(members):
                if block[r, 2 * slots]:
                    out[(s, p)] = self._host(sequences, s, p)
                    continue
                for i0, j0 in zip(block[r, :slots], block[r, slots : 2 * slots]):
                    if j0 >= i0:
                        env_rows.setdefault(int(bank.class_of[p]), []).append(
                            (s, p, int(i0), int(j0), float(scores[r])))

        # alignment of every envelope row, then one more copy
        launched = []
        results = []
        for width, rows in sorted(env_rows.items()):
            # two bfloat16 planes per residue and node
            for part in _budget_groups(rows, lambda row: self._plane_residues(sequences, row),
                                       width * 2 * 2, self.BYTES_BUDGET):
                s_idx, p_idx, iv, jv = (numpy.asarray([row[k] for row in part])
                                        for k in range(4))
                total = torch.as_tensor(numpy.asarray([row[4] for row in part],
                                                      dtype=numpy.float32), device=bank.device)
                res, coords = self._align(pack, s_idx, p_idx, iv, jv, total)
                results.append(torch.cat([res, coords.view(torch.float32)], 1))
                launched.extend(part)
        if launched:
            aligned = to_host(torch.cat(results))
            assemble_domains(out, sequences, self.profiles, launched, aligned)
        return out


class StreamDomains(DeviceDomains):
    """Port of ``gecco_tpu.hmm.stream.StreamDomains.define``: kernels D and
    E are the posterior stage, kernels F and G the alignment stage (split
    into launches as JAX splits its dispatches), the ``DomainHit``
    assembly that of ``stream.py:1679-1726``.  Sequences over 4,096
    residues go to the host engine as in JAX (``stream.py:1499-1501``).
    Kernel F parks the Backward planes of each row's whole sequence.
    """

    def _posteriors(self, pack, s_idx, p_idx):
        fwd, bwd, _abwd, _afwd = _KERNELS[self.backend]
        traj, score = fwd(pack, self.bank, s_idx, p_idx)
        post = bwd(pack, self.bank, s_idx, p_idx, traj, score)
        return score, post[0], post[1]

    def _align(self, pack, s_idx, p_idx, iv, jv, total):
        _fwd, _bwd, abwd, afwd = _KERNELS[self.backend]
        planes, logs = abwd(pack, self.bank, s_idx, p_idx)
        return afwd(pack, self.bank, s_idx, p_idx, planes, logs, iv, jv, total)

    def _plane_residues(self, sequences, row) -> int:
        return len(sequences[row[0]])


def assemble_domains(out: Dict[Tuple[int, int], List[DomainHit]], sequences, profiles,
                     rows, aligned: "numpy.ndarray") -> None:
    """Append the ``DomainHit`` of each envelope row to ``out[(s, p)]`` and
    sort every pair's domains by envelope.

    ``rows[n]`` starts ``(s, p, ienv, jenv)``; ``aligned[n]`` is the row's
    float32 record from kernel G or K: the envelope Forward score, the 21
    null2 log-ratios, then the four int32 alignment coordinates viewed as
    float32.  The arithmetic of ``stream.py:1679-1726`` and
    ``domains.py:265-291``: the null2 correction is the envelope's
    residue-class counts times the log-ratios; the envelope score is
    restored to the whole sequence's length model.
    """
    class_cum: Dict[int, "numpy.ndarray"] = {}
    for (s, p, ienv, jenv, *_rest), values in zip(rows, aligned):
        gm = profiles[p]
        x = sequences[s]
        L = len(x)
        if s not in class_cum:
            onehot = numpy.zeros((L + 1, 21), dtype=numpy.float64)
            onehot[numpy.arange(1, L + 1), numpy.minimum(x, 20)] = 1.0
            class_cum[s] = numpy.cumsum(onehot, axis=0)
        cum = class_cum[s]
        counts_env = cum[jenv] - cum[ienv - 1]
        corr = float(counts_env @ values[1:22])
        loop, _ = length_model(L)
        env_sc = values[0] + (L - (jenv - ienv + 1)) * loop
        dombias = float(numpy.logaddexp(0.0, math.log(engine.OMEGA) + corr))
        bits = (env_sc - (null1_score(L) + dombias)) / LOG2
        tau, lam = gm.hmm.stats.get("FORWARD", (0.0, LOG2))
        tf, tt, hf, ht = values[22:26].copy().view(numpy.int32)
        out[(s, p)].append(DomainHit(
            ienv=ienv, jenv=jenv,
            target_from=int(tf), target_to=int(tt),
            hmm_from=int(hf), hmm_to=int(ht),
            envsc=float(env_sc), dombias=dombias,
            bitscore=float(bits),
            pvalue=float(exp_surv(bits, tau, lam)),
        ))
    for key in out:
        out[key].sort(key=lambda d: (d.ienv, d.jenv))
