"""Pair-dense domain definition (kernels J and K).

Counterpart of ``gecco_tpu.hmm.domains`` and of the two pair kernels it
drives (``gecco_tpu.hmm.kernels``):

* :func:`pair_posterior` (kernel J, ``_pallas_pair_posterior``): for each
  listed pair, in one launch, the Forward score and — from the Forward
  and Backward passes of the same block — the match occupancy ``mocc``,
  the begin posterior ``pB`` and, where asked, the end posterior ``pE``
  per residue.  The Forward trajectories of the special states stay on
  the chip: up to 1,024 nodes a warp a row keeps them in its slice of a
  scratch tensor, which the L2 cache holds between the passes; above, a
  block a row keeps them in shared memory;
* :func:`pair_align` (kernel K, ``_pallas_pair_align``): for each
  envelope row, in one launch, the Backward planes (bfloat16, parked in a
  scratch slice that only the row's warp or block touches), the posteriors, the
  envelope Forward rescore, the optimal-accuracy endpoints and the 21
  null2 log-ratios;
* :class:`PairDomains` — ``PairDomains``: domain definition of candidate
  pairs through J, the envelope finder and K, assembled into
  ``DomainHit`` on the host.

The functions are those of kernels D + E and F + G
(:mod:`gecco_tpu_torch.hmm.stream`), whose recurrences the plain versions
here share; the kernels differ in what leaves the chip.  The TPU kernels
gather ``C`` profile rows per sequence into a ``(St, 8)`` grid of
``[C, Mp]`` cells and truncate their delete chains at ``log2(Mp)``
doublings; here a row is one (sequence, profile) pair, one warp (J to
1,024 nodes, K to 256, in blocks of one profile's rows from
``hmm.kernels.pair_blocks``, as kernels D–G) or one block, and the chains
are exact.  Each wrapper takes the plain version for CPU tensors and
launches its kernel (``csrc/``) or raises for CUDA tensors.
"""

from typing import Optional, Tuple

import numpy
import torch

from .bank import TorchBank
from .kernels import DENSE_WARP_WIDTH, SeqPack, _kernel_device, run_launches
from .stream import (
    _MAX_LPS, ALIGN_FWD_BLOCK_ROWS, DeviceDomains, _check_rows_tensor, _envelope_bounds, _Rows,
    align_bwd_plain, align_fwd_plain, backward_posteriors, forward_trajectories,
)

__all__ = ["pair_posterior", "pair_posterior_plain", "pair_posterior_launches", "pair_align",
           "pair_align_plain", "pair_align_launches", "pair_posterior_smem", "PairDomains"]

#: dynamic shared memory a block of kernel J may take (bytes): the 227 KB
#: a Hopper block can opt into, less 4 KB for the kernel's static scratch
_SMEM_CAP = 232448 - 4096


def pair_posterior_smem(width: int, stride: int) -> int:
    """Dynamic shared memory (bytes) of kernel J's block form (the classes
    above 1,024 nodes) at node width ``width`` and ``stride`` residues:
    the eight transition planes, the
    node mask and the delete-chain basis (``10 width + 1`` values) and the
    six Forward trajectories (``6 stride``), float32."""
    return 4 * (10 * width + 1 + 6 * stride)


# ---------------------------------------------------------------------------
# kernel J: Forward + Backward posteriors of listed pairs
# ---------------------------------------------------------------------------

def pair_posterior(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx, emit_pe: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Posteriors of rows ``(seq_idx[r], prof_idx[r])`` in one launch a
    width class.

    Returns ``(score [n], mocc [n, stride], pB [n, stride], pE)``: the
    Forward score (nats; −1e30 for an empty sequence), the match
    occupancy ``clip(1 − ppN − ppJ − ppC, 0, 1)``, the begin posterior
    and, with ``emit_pe``, the end posterior (else ``None``), zero past
    each row's length; ``stride`` is the longest row.  Raises if the rows
    of the classes above 1,024 nodes need more shared memory than a block
    may take (:func:`pair_posterior_smem`).
    """
    if _kernel_device(pack, bank) == "cpu":
        return pair_posterior_plain(pack, bank, seq_idx, prof_idx, emit_pe)
    launches, out = pair_posterior_launches(pack, bank, seq_idx, prof_idx, emit_pe)
    return run_launches(launches, lambda: out)


def pair_posterior_launches(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx,
                            emit_pe: bool = True):
    """Kernel J's launches over these rows (:meth:`~.stream._Rows.launches`:
    one a width class up to 1,024 nodes, a warp a row in blocks of one
    profile's rows, and one for the classes above, a block a row at the
    call's width) and the ``(score, mocc, pB, pE)`` they fill once every
    one has run.  The warp form keeps each row's six Forward trajectories
    in its slice of a scratch tensor (``[6, n, stride]`` float32, dropped
    with the launches); the block form keeps them in shared memory."""
    rows = _Rows(pack, bank, seq_idx, prof_idx)
    classes = bank.class_of[rows.prof_host]
    if (classes > DENSE_WARP_WIDTH).any():
        need = pair_posterior_smem(rows.width, rows.stride)
        if need > _SMEM_CAP:
            raise ValueError(
                f"pair_posterior: {rows.stride} residues at width {rows.width} need {need} "
                f"bytes of shared memory a block, over {_SMEM_CAP}")
    n_post = 3 if emit_pe else 2
    device = bank.device
    score = torch.empty(rows.n, dtype=torch.float32, device=device)
    post = torch.empty((n_post, rows.n, rows.stride), dtype=torch.float32, device=device)
    traj = (torch.empty((6, rows.n, rows.stride), dtype=torch.float32, device=device)
            if (classes <= DENSE_WARP_WIDTH).any() else None)
    launches = rows.launches("gecco_pair_posterior", "pair_posterior", n_post, traj, score, post)
    return launches, (score, post[0], post[1], post[2] if emit_pe else None)


def pair_posterior_plain(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx, emit_pe: bool = True):
    """Plain PyTorch kernel J: kernel D's Forward recording ``E`` as well,
    then kernel E's Backward emitting ``pE`` as well."""
    rows = _Rows(pack, bank, seq_idx, prof_idx)
    traj, score = forward_trajectories(rows)
    post = backward_posteriors(rows, traj, score, 3 if emit_pe else 2)
    return score, post[0], post[1], post[2] if emit_pe else None


# ---------------------------------------------------------------------------
# kernel K: Backward planes and envelope alignment of listed envelope rows
# ---------------------------------------------------------------------------

def pair_align(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx, iv, jv,
               total: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score and align envelope ``[iv[r], jv[r]]`` (1-based, inclusive) of
    each row in one launch a width class.

    ``iv`` and ``jv`` are host integers, checked against the rows' lengths
    before they are uploaded; ``total`` is each row's Forward score
    (:func:`pair_posterior`).  Returns ``out [n, 22]`` float32 — the
    envelope Forward score under the envelope's own length model, then
    the 21 null2 log-ratios — and ``coords [n, 4]`` int32: target
    from/to, HMM from/to of the optimal-accuracy alignment.
    """
    if _kernel_device(pack, bank) == "cpu":
        return pair_align_plain(pack, bank, seq_idx, prof_idx, iv, jv, total)
    launches, out = pair_align_launches(pack, bank, seq_idx, prof_idx, iv, jv, total)
    return run_launches(launches, lambda: out)


def pair_align_launches(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx, iv, jv,
                        total: torch.Tensor):
    """Kernel K's launches over these envelope rows (:meth:`~.stream._Rows.launches`
    with blocks of ``ALIGN_FWD_BLOCK_ROWS``: a warp a row at 128 and 256
    nodes, a block a row above; each reads the envelope and total at each
    row's slot) and the ``(out, coords)`` they fill once every one has
    run.  The kernel parks the Backward planes of each envelope's residues
    in a scratch tensor of ``n × longest envelope × width`` bfloat16 pairs,
    allocated here and dropped with the launches."""
    rows = _Rows(pack, bank, seq_idx, prof_idx)
    iv_dev, jv_dev = _envelope_bounds(rows, iv, jv)
    longest = int((numpy.asarray(jv) - numpy.asarray(iv)).max(initial=0)) + 1
    _check_rows_tensor(total, (rows.n,), torch.float32, "total")
    device = bank.device
    out = torch.empty((rows.n, 22), dtype=torch.float32, device=device)
    coords = torch.empty((rows.n, 4), dtype=torch.int32, device=device)
    planes = torch.empty((2, rows.n, longest, rows.width), dtype=torch.bfloat16, device=device)
    logs = torch.empty((4, rows.n, longest), dtype=torch.float32, device=device)
    launches = rows.launches("gecco_pair_align", "pair_align", rows.width, iv_dev, jv_dev, total,
                             longest, planes, logs, out, coords,
                             rows_per_block=ALIGN_FWD_BLOCK_ROWS)
    return launches, (out, coords)


def pair_align_plain(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx, iv, jv,
                     total: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch kernel K: kernel F's Backward planes (rounded to
    bfloat16), then kernel G's Forward pass over them; tie rules of the
    optimal-accuracy DP as :func:`stream.align_fwd_plain` states them."""
    planes, logs = align_bwd_plain(pack, bank, seq_idx, prof_idx)
    return align_fwd_plain(pack, bank, seq_idx, prof_idx, planes, logs, iv, jv, total)


# ---------------------------------------------------------------------------
# domain definition of candidate pairs
# ---------------------------------------------------------------------------

class PairDomains(DeviceDomains):
    """Port of ``gecco_tpu.hmm.domains.PairDomains.define``: kernel J is
    the posterior stage (``emit_pe=False``: the envelope finder reads only
    ``mocc`` and ``pB``) and kernel K the alignment stage, one launch each
    per width class and byte budget; the envelope finder, the two copies
    to the host, the host engine for overflowing pairs and the
    ``DomainHit`` assembly are :class:`~gecco_tpu_torch.hmm.stream.DeviceDomains`'.

    The TPU's gate (``Lp × Mp`` over ``512 × 512`` cells to the host
    engine) is the size of its VMEM scratch, not of the method.  The
    port's gate: a pair stays on the device if its sequence has at most
    4,096 residues (``_MAX_LPS``, JAX's pack limit) and kernel
    J's shared memory for it fits a block — ``4 (10 width + 1 + 6 L)``
    bytes within 227 KB less 4 KB, which refuses only sequences over
    ~2,680 residues against the 4,096-node class; every narrower class
    takes 4,096 residues.  Kernel K's scratch is device memory, ``4 width``
    bytes a residue of the envelope, cut into launches under
    :attr:`BYTES_BUDGET`.  :attr:`counts` holds the refused
    (``host_pairs.length``) and the overflowing pairs of the last
    :meth:`define`, :attr:`host_pairs` their sum.  A repeated pair reports
    once and an empty sequence has no domains (the TPU kernels clamp its
    length to 1 and score a padding residue).
    """

    def _on_device(self, length: int, width: int) -> bool:
        return length <= _MAX_LPS and pair_posterior_smem(width, length) <= _SMEM_CAP

    def _posteriors(self, pack, s_idx, p_idx):
        kernel = pair_posterior if self.backend == "cuda" else pair_posterior_plain
        score, mocc, pb, _pe = kernel(pack, self.bank, s_idx, p_idx, emit_pe=False)
        return score, mocc, pb

    def _align(self, pack, s_idx, p_idx, iv, jv, total):
        kernel = pair_align if self.backend == "cuda" else pair_align_plain
        return kernel(pack, self.bank, s_idx, p_idx, iv, jv, total)

    def _plane_residues(self, sequences, row) -> int:
        if self.backend == "torch":
            return len(sequences[row[0]])   # the plain version parks whole sequences
        return row[3] - row[2] + 1
