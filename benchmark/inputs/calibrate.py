"""Compute the bank's E-value calibration once, in plain PyTorch.

hmmbuild's fit as the port's ``calibrate`` makes it: ``n`` random background
sequences of ``L`` residues (the port's ``background_sequences`` draws) are
scored against every profile with the SSV filter (for the MSV statistics),
Viterbi and Forward, in float64; ``lambda = log 2``; the Gumbel location is
the maximum-likelihood one; Forward's exponential tail is anchored at the
``tailp`` quantile.  The recurrences are written out here over tensors of
``[sequences, profiles, nodes]``, profiles grouped by length, so that no
kernel of the port computes the benchmark's inputs.

Run on a card (the CPU takes hours for the full bank)::

    python -m benchmark.inputs.calibrate --device cuda

It writes ``benchmark/inputs/calibration.npz`` (and its provenance beside it).
"""

import argparse
import json
import math
import os
import time

import numpy
import torch

from . import synthetic

LOG2 = math.log(2.0)
#: stands in for log(0) along a delete chain: the prefix transform
#: ``T + cum(a - T)`` needs finite steps
BREAK = -1.0e4


def background_sequences(n: int = 256, L: int = 256, seed: int = 0) -> "numpy.ndarray":
    rng = numpy.random.default_rng(seed)
    p_bg = synthetic.BACKGROUND_F / synthetic.BACKGROUND_F.sum()
    return numpy.stack([rng.choice(20, size=L, p=p_bg) for _ in range(n)])


def _log(a):
    with numpy.errstate(divide="ignore"):
        return numpy.log(a)


def configure(gm: synthetic.Profile):
    """Local multihit log-space parameters of one profile (``configure_local``)."""
    M, t = gm.M, gm.trans
    msc = numpy.full((M + 1, 21), -numpy.inf)
    msc[1:, :20] = _log(gm.match[1:] / synthetic.BACKGROUND_F[None, :])
    msc[1:, 20] = 0.0
    occ = numpy.zeros(M + 1)
    occ[1] = t[0, 0] + t[0, 1]
    for k in range(2, M + 1):
        occ[k] = occ[k - 1] * (t[k - 1, 0] + t[k - 1, 1]) + (1.0 - occ[k - 1]) * t[k - 1, 5]
    Z = float(numpy.sum(occ[1:] * (M - numpy.arange(1, M + 1) + 1.0)))
    bm = numpy.full(M + 1, -numpy.inf)
    bm[1:] = _log(occ[1:] / Z)
    logt = _log(t)
    return {"msc": msc, "tmm": logt[:, 0], "tmi": logt[:, 1], "tmd": logt[:, 2],
            "tim": logt[:, 3], "tii": logt[:, 4], "tdm": logt[:, 5], "tdd": logt[:, 6],
            "bm": bm, "loop_e": math.log(0.5), "move_e": math.log(0.5)}


def length_model(L: int):
    """``(loop, move)`` of the multihit N/C/J length model of ``L`` residues."""
    return math.log(L / (L + 3.0)), math.log(3.0 / (L + 3.0))


def null1(L: int) -> float:
    """The null model's score of ``L`` residues (nats)."""
    return L * math.log(L / (L + 1.0)) + math.log(1.0 / (L + 1.0))


def _group_tensors(group, device):
    """Node-major parameters of a group, padded to its longest profile."""
    P, Mp = len(group), max(gm.M for gm in group)
    neg = -numpy.inf
    e = numpy.full((21, P, Mp + 1), neg)
    tr = {k: numpy.full((P, Mp + 1), neg) for k in ("tmm", "tim", "tdm", "tmi", "tii", "tmd", "tdd", "bm")}
    tbm = numpy.zeros(P)
    for p, gm in enumerate(group):
        c = configure(gm)
        M = gm.M
        e[:, p, : M + 1] = c["msc"].T
        for k in tr:
            tr[k][p, : M + 1] = c[k]
        tbm[p] = math.log(2.0 / (M * (M + 1.0)))
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    return as_t(e), {k: as_t(v) for k, v in tr.items()}, as_t(tbm)


def _chain(a, lt, semiring):
    """``d[k] = op(a[k], d[k-1] + lt[k-1])`` along the last axis (``d[-1]`` = -inf)."""
    lt = torch.where(torch.isfinite(lt), lt, torch.full_like(lt, BREAK))
    T = torch.cat([torch.zeros_like(lt[..., :1]), torch.cumsum(lt, -1)[..., :-1]], -1)
    if semiring == "max":
        return T + torch.cummax(a - T, -1).values
    return T + torch.logcumsumexp(a - T, -1)


def score_group(group, xs: "torch.Tensor", algorithm: str) -> "numpy.ndarray":
    """Scores (nats) ``[S, P]`` of every sequence against every profile of the
    group with ``algorithm``: ``"ssv"``, ``"viterbi"`` or ``"forward"``."""
    device = xs.device
    e, tr, tbm = _group_tensors(group, device)
    S, L = xs.shape
    P, W = e.shape[1], e.shape[2]
    loop, move = length_model(L)
    neg = torch.tensor(-math.inf, dtype=torch.float64, device=device)
    op = torch.maximum if algorithm != "forward" else torch.logaddexp
    reduce = (lambda t: t.amax(-1)) if algorithm != "forward" else (lambda t: torch.logsumexp(t, -1))
    Mx = torch.full((S, P, W), -math.inf, dtype=torch.float64, device=device)
    Ix, Dx = Mx.clone(), Mx.clone()
    N = torch.zeros(S, 1, dtype=torch.float64, device=device)
    B = N + move
    J = torch.full((S, P), -math.inf, dtype=torch.float64, device=device)
    C = J.clone()
    B = B.expand(S, P).clone()
    shift = lambda t: torch.cat([neg.expand(*t.shape[:-1], 1), t[..., :-1]], -1)  # noqa: E731
    for i in range(L):
        ei = e.index_select(0, xs[:, i])
        if algorithm == "ssv":
            Mn = ei + torch.maximum(shift(Mx), (B + tbm[None, :])[..., None])
            Mn[..., 0] = -math.inf
            E = Mn.amax(-1)
            C = torch.maximum(C + loop, E + math.log(0.5))
            B = (N + (i + 1) * loop + move).expand(S, P)
            Mx = Mn
            continue
        stay = op(op(shift(Mx + tr["tmm"]), shift(Ix + tr["tim"])), shift(Dx + tr["tdm"]))
        Mn = ei + op(stay, B[..., None] + tr["bm"])
        Mn[..., 0] = -math.inf
        In = op(Mx + tr["tmi"], Ix + tr["tii"])
        In[..., 0] = -math.inf
        Dn = _chain(shift(Mn + tr["tmd"]), tr["tdd"].expand(S, P, W),
                    "max" if op is torch.maximum else "sum")
        Dn[..., 0] = -math.inf
        E = op(reduce(Mn), reduce(Dn))
        J = op(J + loop, E + math.log(0.5))
        C = op(C + loop, E + math.log(0.5))
        B = op((N + (i + 1) * loop + move).expand(S, P), J + move)
        Mx, Ix, Dx = Mn, In, Dn
    return (C + move).cpu().numpy()


def calibrate(bank, *, device, n=256, L=256, seed=0, tailp=0.04, group=64):
    """``[P, 3, 2]`` statistics: MSV (SSV-scored), VITERBI, FORWARD x (location, lambda)."""
    xs = torch.as_tensor(background_sequences(n, L, seed), device=device)
    order = numpy.argsort([gm.M for gm in bank], kind="stable")
    out = numpy.zeros((len(bank), 3, 2))
    null = null1(L)
    lam = LOG2
    for g in range(0, len(order), group):
        idx = order[g : g + group]
        members = [bank[i] for i in idx]
        bits = [(score_group(members, xs, a) - null) / LOG2 for a in ("ssv", "viterbi", "forward")]
        mu = -numpy.log(numpy.mean(numpy.exp(-lam * bits[0]), axis=0)) / lam
        vmu = -numpy.log(numpy.mean(numpy.exp(-lam * bits[1]), axis=0)) / lam
        tau = numpy.quantile(bits[2], 1.0 - tailp, axis=0) + math.log(tailp) / lam
        out[idx, 0, 0], out[idx, 1, 0], out[idx, 2, 0] = mu, vmu, tau
    out[:, :, 1] = lam
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--profiles", type=int, default=2766)
    parser.add_argument("--seed", type=int, default=0, help="the bank's seed")
    parser.add_argument("--out", default=os.path.join(synthetic.HERE, "calibration.npz"))
    args = parser.parse_args()
    t0 = time.perf_counter()
    lengths = synthetic.pfam_shaped_lengths(args.profiles, seed=args.seed)
    bank = synthetic.pfam_shaped_profiles(args.profiles, seed=args.seed)
    stats = calibrate(bank, device=torch.device(args.device))
    numpy.savez_compressed(args.out, stats=stats, lengths=lengths,
                           count=args.profiles, seed=args.seed)
    device = torch.device(args.device)
    provenance = {
        "command": "python -m benchmark.inputs.calibrate --device " + args.device,
        "bank": f"pfam_shaped_profiles({args.profiles}, seed={args.seed})",
        "sequences": "256 background sequences of 256 residues, numpy default_rng(0)",
        "fit": "lambda = log 2; MSV and VITERBI Gumbel location by maximum likelihood "
               "(MSV from SSV scores); FORWARD tau at the 0.04 tail quantile",
        "arithmetic": "float64, plain torch (benchmark/inputs/calibrate.py)",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "torch": torch.__version__,
        "seconds": round(time.perf_counter() - t0, 1),
    }
    with open(os.path.splitext(args.out)[0] + ".json", "w") as f:
        json.dump(provenance, f, indent=1)
        f.write("\n")
    print(json.dumps(provenance))


if __name__ == "__main__":
    main()
