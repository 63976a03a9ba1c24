#!/usr/bin/env python3
"""Time one evaluation of the CRF training objective and its gradient on the
card, as the port writes it and as others could.

Run from the root of a checkout, on a machine with one NVIDIA GPU::

    python3 tools/torch_crf_objective.py

It builds ``chip_smoke.py`` phase 8a's corpus and index tensor (240 contigs
x 500 genes, the shipped model's settings and selected width), then
evaluates the negative log-likelihood and its autograd gradient at a seeded
point in each form below, several times each: device milliseconds between
CUDA events, the profiler's busy milliseconds and its costliest kernels,
whether repeated evaluations are equal bit for bit, and the largest
difference from ``gecco_tpu_torch.crf.train.nll`` (the padding row, which
the fit freezes, left out).

* ``port``: ``train.nll`` (emissions as an embedding lookup, transitions
  scored by counting each window's transitions of each kind);
* ``indexed``: the JAX package's form, ``state[idx]`` and
  ``trans[y[:, :-1], y[:, 1:]]``;
* ``indexed_transitions``: the port's emissions, the JAX package's
  transitions;
* ``index_select``: the emissions by ``torch.index_select``, whose
  backward adds with atomics.
"""

import json
import os
import subprocess
import sys
import warnings

sys.modules["jax"] = None
sys.modules["gecco_tpu"] = None
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy
import torch

#: evaluations timed between CUDA events, and checked for repeats
REPEATS = 5


def emissions_embedding(state, idx):
    return torch.nn.functional.embedding(idx, state).sum(dim=2)


def emissions_indexed(state, idx):
    return state[idx].sum(dim=2)


def emissions_index_select(state, idx):
    return torch.index_select(state, 0, idx.reshape(-1)).view(*idx.shape, 2).sum(dim=2)


def transitions_counted(trans, y):
    counts = torch.nn.functional.one_hot(2 * y[:, :-1] + y[:, 1:], 4).sum(dim=1)
    return counts.to(trans.dtype) @ trans.reshape(4)


def transitions_indexed(trans, y):
    return trans[y[:, :-1], y[:, 1:]].sum(dim=1)


FORMS = {
    "port": None,
    "indexed": (emissions_indexed, transitions_indexed),
    "indexed_transitions": (emissions_embedding, transitions_indexed),
    "index_select": (emissions_index_select, transitions_counted),
}


def objective(form, state, trans, idx, y, c2):
    """``train.nll``'s arithmetic with the emissions and transitions of
    ``form``."""
    from gecco_tpu_torch.crf import train

    if FORMS[form] is None:
        return train.nll(state, trans, idx, y, c2)
    emissions, transitions = FORMS[form]
    e = emissions(state, idx)
    y = y.long()
    path = torch.gather(e, 2, y[..., None])[..., 0].sum(dim=1) + transitions(trans, y)
    alpha = e[:, 0, :]
    for t in range(1, e.shape[1]):
        alpha = torch.logsumexp(alpha[:, :, None] + trans[None, :, :], dim=1) + e[:, t, :]
    loss = (torch.logsumexp(alpha, dim=1) - path).sum()
    if c2 > 0:
        loss = loss + c2 * (torch.sum(state ** 2) + torch.sum(trans ** 2))
    return loss


def evaluate(form, x, idx, y, c2):
    n_state = x.size - 4
    xj = torch.from_numpy(numpy.asarray(x, dtype=numpy.float32)).to(idx.device)
    xj.requires_grad_(True)
    f = objective(form, xj[:n_state].view(-1, 2), xj[n_state:].view(2, 2), idx, y, c2)
    (g,) = torch.autograd.grad(f, xj)
    return torch.cat([f.detach().reshape(1), g]).cpu().numpy().astype(numpy.float64)


def main():
    if not torch.cuda.is_available():
        print("torch_crf_objective: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    import chip_smoke
    from gecco_tpu_torch.crf import ClusterCRF

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    device = torch.device("cuda:0")
    shipped = numpy.load(os.path.join(os.path.dirname(chip_smoke.__file__), "gecco_tpu_torch",
                                      "data", "crf_model.npz"), allow_pickle=True)
    names = [str(n) for n in shipped["sig_names"]]
    settings = {key: shipped[key].item() for key in
                ("feature_type", "window_size", "window_step", "algorithm", "c1", "c2")}
    pool = numpy.random.default_rng(chip_smoke.TRAIN_SEED).choice(
        len(names), size=chip_smoke.CLUSTER_POOL, replace=False)
    corpus = chip_smoke.training_corpus(names, pool, chip_smoke.TRAIN_CONTIGS,
                                        chip_smoke.TRAIN_GENES, chip_smoke.TRAIN_SEED)
    with chip_smoke.fit_probes() as probe, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ClusterCRF(**settings).fit(corpus, device=device, max_iterations=1,
                                   select=len(shipped["attr_names"]) / len(names))
    _x, idx, y, c2 = probe["args"]
    A = int(idx.max())
    padding = float((idx == A).float().mean())
    print(f"# index tensor {list(idx.shape)}, {A} features, {padding:.3f} of its entries "
          f"the padding row", flush=True)
    x = numpy.random.default_rng(0).normal(scale=0.1, size=2 * (A + 1) + 4)
    x[2 * A : 2 * A + 2] = 0.0
    keep = numpy.ones(x.size + 1, dtype=bool)
    keep[1 + 2 * A : 3 + 2 * A] = False  # the frozen padding row's gradient

    reference = evaluate("port", x, idx, y, c2)
    for form in FORMS:
        first = evaluate(form, x, idx, y, c2)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        repeats = [evaluate(form, x, idx, y, c2) for _ in range(REPEATS)]
        end.record()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            evaluate(form, x, idx, y, c2)
            torch.cuda.synchronize()
        by_kernel = sorted(((ms, key) for key, ms in chip_smoke.device_ms(prof).items()),
                           reverse=True)
        diff = numpy.abs(first - reference)[keep]
        print(json.dumps({
            "form": form, "ms": start.elapsed_time(end) / REPEATS,
            "busy_ms": sum(ms for ms, _ in by_kernel),
            "repeats_equal": all(numpy.array_equal(r, first) for r in repeats),
            "objective_rel_to_port": float(diff[0] / abs(reference[0])),
            "gradient_rel_to_port": float(diff[1:].max() / numpy.abs(reference[keep][1:]).max()),
            "kernels": [[round(ms, 3), key[:90]] for ms, key in by_kernel[:4]],
        }), flush=True)


if __name__ == "__main__":
    main()
