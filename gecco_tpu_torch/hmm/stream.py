"""Forward scores of listed pairs (kernel C): the F3 rescore.

Counterpart of ``gecco_tpu.hmm.stream.StreamScores.flat_packed`` with
``viterbi=False`` over its ``StreamBank``.  The JAX package pre-gathers
each pair's emission stream (``StreamScores._jit_score``) and falls back
to the pair kernels for sequences longer than 4,096 residues; kernel C
reads emission rows by residue index from the bank tensor and takes any
length, so neither the gather nor the fallback is needed here.

An empty sequence scores −1e30 (``stream.py:1287-1297``).
"""

import torch

from .bank import NEG, TorchBank
from .kernels import SeqPack, _kernel_device, launch_pairs, pair_groups

__all__ = ["forward_pairs", "forward_pairs_plain"]


def forward_pairs(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx) -> torch.Tensor:
    """Forward scores (nats) of pairs ``(seq_idx[r], prof_idx[r])``, ``[n]``."""
    if _kernel_device(pack, bank) == "cpu":
        return forward_pairs_plain(pack, bank, seq_idx, prof_idx)
    return launch_pairs("gecco_forward_pairs", "forward_pairs", pack, bank,
                        seq_idx, prof_idx, log_space=False)


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


def forward_pairs_plain(pack: SeqPack, bank: TorchBank, seq_idx, prof_idx,
                        chunk: int = 4096) -> torch.Tensor:
    """Plain PyTorch Forward (probability space, rescaled every residue).

    The delete chain ``D_k = D_{k-1} tdd_{k-1} + M_{k-1} tmd_{k-1}`` is an
    exact doubling scan over the whole node axis.
    """
    device = bank.device
    out = torch.empty(len(seq_idx), dtype=torch.float32, device=device)
    xs_all = pack.padded()
    for pos, s, p, W in pair_groups(bank, seq_idx, prof_idx, chunk):
        R = len(pos)
        tmm, tim, tdm, tmi, tii, tmd, tdd, bm = bank.trans[:, p, :W]
        lens = pack.lens.long()[s]
        loop = pack.loops_exp[s][:, None]
        move = pack.moves_exp[s][:, None]
        xs = xs_all[s]
        zero = torch.zeros((R, W), dtype=torch.float32, device=device)
        col = zero[:, :1]
        shifted_tdd = torch.cat([col, tdd[:, :-1]], 1)
        M, I, D = zero, zero, zero
        N = col + 1.0
        B = move.clone()
        J, C, ls = col.clone(), col.clone(), col.clone()
        score = torch.full((R, 1), NEG, dtype=torch.float32, device=device)
        for i in range(int(lens.max()) if R else 0):
            alive = (i < lens)[:, None]
            e = bank.e_odds[xs[:, i], p, :W]
            stay = M * tmm + I * tim + D * tdm
            Mn = e * (torch.cat([col, stay[:, :-1]], 1) + B * bm)
            In = M * tmi + I * tii
            Dn = _affine_scan(shifted_tdd, torch.cat([col, (Mn * tmd)[:, :-1]], 1))
            E = (Mn + Dn).sum(dim=1, keepdim=True)
            Jn = J * loop + E * 0.5
            Cn = C * loop + E * 0.5
            Nn = N * loop
            Bn = (Nn + Jn) * move
            total = E + Bn + Nn + Cn + 1e-30
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
