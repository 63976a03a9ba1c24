"""CRF training: elastic-net-regularized maximum likelihood in PyTorch.

Port of ``gecco_tpu.crf.train`` (reference: ``gecco/crf/__init__.py:275-378``,
``ClusterCRF.fit``): optional Fisher feature selection, contig grouping
and shuffling, one training instance per sliding window, then an
L1(+L2)-regularized linear-chain CRF fit.  The instances, the index
tensor and the host optimizers (OWL-QN/L-BFGS in float64 numpy, the
orthant projection and the L1 gauge fix) are copied as they are.  The
objective, :func:`nll`, runs in float32 on the fit's device as plain
torch ops, and ``torch.autograd`` gives its gradient where the JAX
package used ``jax.value_and_grad``; ``algorithm="adam"`` runs
``torch.optim.Adam`` in place of ``optax.adam``, with the same proximal
soft-threshold for the L1 term.
"""

import random as _random
import warnings
from typing import Dict, Iterable, List, Optional

import numpy
import torch

from .._device import resolve_device
from ..model import Gene
from . import features as _features

__all__ = ["fit_crf", "nll"]


def _build_instances(crf, genes: Iterable[Gene], shuffle: bool, seed: int):
    if crf.feature_type == "protein":
        extract_features = _features.extract_features_protein
        extract_labels = _features.extract_labels_protein
    else:
        extract_features = _features.extract_features_domain
        extract_labels = _features.extract_labels_domain

    import itertools
    import operator

    genes = sorted(genes, key=operator.attrgetter("source.id"))
    for gene in genes:
        gene.protein.domains.sort(key=operator.attrgetter("start"))

    groups = itertools.groupby(genes, key=operator.attrgetter("source.id"))
    sequences = [sorted(group, key=operator.attrgetter("start")) for _, group in groups]
    if shuffle:
        _random.Random(seed).shuffle(sequences)

    window, step = crf.window_size, crf.window_step
    all_features: List[List[Dict[str, bool]]] = []
    all_labels: List[List[str]] = []
    from .._meta import sliding_window

    for sequence in sequences:
        feats = extract_features(sequence)
        labels = extract_labels(sequence)
        if all(label == "0" for label in labels):
            warnings.warn(
                f"only negative labels found in sequence {sequence[0].source.id!r}",
                UserWarning,
            )
        elif all(label == "1" for label in labels):
            warnings.warn(
                f"only positive labels found in sequence {sequence[0].source.id!r}",
                UserWarning,
            )
        if len(feats) != len(labels):
            raise ValueError("different number of features and labels found, something is wrong")
        if len(feats) < window:
            raise ValueError(
                f"{sequence[0].source.id!r} has not enough observations "
                f"({len(feats)}) for requested window size ({window})"
            )
        for win in sliding_window(len(feats), window, step):
            all_features.append(feats[win])
            all_labels.append(labels[win])
    return all_features, all_labels


def nll(state: torch.Tensor, trans: torch.Tensor, idx: torch.Tensor, y: torch.Tensor,
        c2: float = 0.0) -> torch.Tensor:
    """Summed negative log-likelihood of the windows, plus the L2 term.

    Arguments:
        state: ``[A + 1, 2]`` state weights; row ``A`` is the padding row.
        trans: ``[2, 2]`` transition weights.
        idx: ``[N, W, dmax]`` feature rows of each window position
            (``A`` where a position has fewer than ``dmax`` features).
        y: ``[N, W]`` labels.
        c2: strength of the L2 term ``c2 * (|state|^2 + |trans|^2)``.

    The forward algorithm runs in log space over the ``W - 1``
    positions after the first, as the JAX package's ``lax.scan`` does.
    The emissions ``state[idx]`` are gathered as an embedding lookup,
    whose backward sums each row's gradient in a fixed order on the CPU
    as on the card.  The backward of advanced indexing sums in whatever
    order the CPU's threads take, so the gradient at one point could
    change from one evaluation to the next and two fits of one corpus
    stop at different points.
    """
    e = torch.nn.functional.embedding(idx, state).sum(dim=2)  # [N, W, 2]
    y_long = y.long()
    path = torch.gather(e, 2, y_long[..., None])[..., 0].sum(dim=1)
    # each window's transitions counted by kind (0→0, 0→1, 1→0, 1→1):
    # indexing ``trans`` by the label pairs would sum its gradient over
    # millions of repeats of four indices, one after another
    counts = torch.nn.functional.one_hot(2 * y_long[:, :-1] + y_long[:, 1:], 4).sum(dim=1)
    path = path + counts.to(e.dtype) @ trans.reshape(4)
    alpha = e[:, 0, :]
    for t in range(1, e.shape[1]):
        alpha = torch.logsumexp(alpha[:, :, None] + trans[None, :, :], dim=1) + e[:, t, :]
    loss = (torch.logsumexp(alpha, dim=1) - path).sum()
    if c2 > 0:
        loss = loss + c2 * (torch.sum(state ** 2) + torch.sum(trans ** 2))
    return loss


def _value_and_grad(x: "numpy.ndarray", idx: torch.Tensor, y: torch.Tensor, c2: float):
    """``nll`` and its gradient at the flat float64 point ``x`` (state rows,
    then ``trans``): one float32 upload, one download of both results."""
    n_state = x.size - 4
    xj = torch.from_numpy(numpy.asarray(x, dtype=numpy.float32)).to(idx.device)
    xj.requires_grad_(True)
    f = nll(xj[:n_state].view(-1, 2), xj[n_state:].view(2, 2), idx, y, c2)
    (g,) = torch.autograd.grad(f, xj)
    out = torch.cat([f.detach().reshape(1), g]).cpu().numpy().astype(numpy.float64)
    return float(out[0]), out[1:]


def fit_crf(
    crf,
    genes: Iterable[Gene],
    *,
    device,
    select: Optional[float] = None,
    shuffle: bool = True,
    correction_method: Optional[str] = None,
    seed: int = 42,
    max_iterations: int = 500,
    learning_rate: float = 0.05,
    tolerance: float = 1e-6,
) -> None:
    """Fit ``crf`` in place on the given training genes.

    The objective and gradients evaluate in float32 on ``device``
    (``"cuda"`` or ``"cpu"``; asking for a card where there is none
    raises); ``tolerance`` below ~1e-7 relative cannot be honored (a
    float32 ulp of a genome-scale summed NLL is larger), and the
    optimizer stops when improvements fall below float32 resolution.
    """
    device = resolve_device(device)
    genes = list(genes)

    # -- optional Fisher feature selection (crf/__init__.py:319-345)
    if select is None:
        # a refit without selection must not carry a previous fit's
        # significance metadata into save()
        crf.significance = None
        crf.significant_features = None
    else:
        from .select import fisher_significance

        if select <= 0 or select > 1:
            raise ValueError(f"invalid value for select: {select}")
        crf.significance = sig = fisher_significance(
            (gene.protein for gene in genes),
            correction_method=correction_method,
        )
        sorted_sig = sorted(sig, key=sig.get)[: int(select * len(sig))]
        if not sorted_sig:
            raise ValueError(
                f"select={select} keeps 0 of {len(sig)} features; "
                "increase the selected fraction")
        crf.significant_features = frozenset(sorted_sig)
        if sig[sorted_sig[-1]] == 1.0:
            warnings.warn(
                "Selected features still include domains with a p-value "
                "of 1, consider reducing the selected fraction.",
                UserWarning,
            )
        genes = [
            gene.with_protein(
                gene.protein.with_domains([
                    domain for domain in gene.protein.domains
                    if domain.name in crf.significant_features
                ])
            )
            for gene in genes
        ]

    windows, labels = _build_instances(crf, genes, shuffle, seed)
    if not windows:
        raise ValueError("no training instances")

    # -- vocabulary over observed features
    vocabulary = sorted({name for window in windows for feats in window for name in feats})
    attr_index = {name: i for i, name in enumerate(vocabulary)}
    A = len(vocabulary)
    W = crf.window_size
    N = len(windows)
    # windows is non-empty and every window has W >= 1 positions; the
    # max(..., 1) handles the all-empty-feature-dicts corpus (dmax == 0)
    dmax = max(max(
        len(feats) for window in windows for feats in window), 1)

    idx = numpy.full((N, W, dmax), A, dtype=numpy.int32)  # A = padding row
    y = numpy.zeros((N, W), dtype=numpy.int32)
    for n, (window, window_labels) in enumerate(zip(windows, labels)):
        for t, feats in enumerate(window):
            for d, name in enumerate(feats):
                idx[n, t, d] = attr_index[name]
        y[n] = [1 if label == "1" else 0 for label in window_labels]

    c1 = float(crf._options.get("c1", 0.0))
    c2 = float(crf._options.get("c2", 0.0))
    ignored = set(crf._options) - {"c1", "c2"}
    if ignored:
        # the reference forwards arbitrary options to CRFsuite; this
        # trainer implements the elastic net only — say so instead of
        # silently training with defaults (a typo like C1= would
        # otherwise produce a dense unregularized model)
        warnings.warn(
            f"ignoring unsupported CRF training options: {sorted(ignored)} "
            "(this trainer supports c1/c2)", UserWarning)

    idx_t = torch.from_numpy(idx).to(device)
    y_t = torch.from_numpy(y).to(device)

    algorithm = getattr(crf, "algorithm", "lbfgs")
    if algorithm in ("lbfgs", "l-bfgs", "owlqn"):
        state, trans = _fit_owlqn(
            idx_t, y_t, A, c1, c2, max_iterations=max_iterations,
            tolerance=tolerance,
        )
    elif algorithm == "adam":
        state, trans = _fit_adam(
            idx_t, y_t, A, c1, c2, max_iterations=max_iterations,
            learning_rate=learning_rate, tolerance=tolerance,
        )
    else:
        raise ValueError(f"unsupported training algorithm: {algorithm!r}")
    # record the final objective (CRFsuite keeps a trainer log in the
    # pickled model; this is our equivalent for inspection/tests)
    with torch.no_grad():
        final = float(nll(
            torch.as_tensor(state, dtype=torch.float32, device=device),
            torch.as_tensor(trans, dtype=torch.float32, device=device),
            idx_t, y_t, c2))
    crf.last_objective_ = final + c1 * float(
        numpy.abs(state).sum() + numpy.abs(trans).sum()
    )
    crf._set_weights(vocabulary, ["0", "1"], state[:A], trans)


def _fit_adam(idx, y, A, c1, c2, *, max_iterations, learning_rate, tolerance):
    """Proximal Adam on the elastic-net objective (alternative path)."""
    state = torch.zeros((A + 1, 2), dtype=torch.float32, device=idx.device, requires_grad=True)
    trans = torch.zeros((2, 2), dtype=torch.float32, device=idx.device, requires_grad=True)
    optimizer = torch.optim.Adam([state, trans], lr=learning_rate, eps=1e-8)

    previous = numpy.inf
    for iteration in range(max_iterations):
        lr_scale = 1.0 if iteration < max_iterations * 3 // 4 else 0.1
        for group in optimizer.param_groups:
            group["lr"] = learning_rate * lr_scale
        optimizer.zero_grad(set_to_none=True)
        loss = nll(state, trans, idx, y, c2)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            if c1 > 0:
                # proximal soft-threshold for the L1 penalty (CRFsuite's
                # orthantwise penalty covers ALL features incl transitions)
                threshold = c1 * learning_rate * lr_scale
                for p in (state, trans):
                    p.copy_(torch.sign(p) * torch.clamp(torch.abs(p) - threshold, min=0.0))
            state[A] = 0.0  # keep the padding row at zero
        loss = float(loss)
        if abs(previous - loss) < tolerance * max(1.0, abs(loss)):
            break
        previous = loss
    return (state.detach().cpu().numpy().astype(numpy.float64),
            trans.detach().cpu().numpy().astype(numpy.float64))


def _fit_owlqn(idx, y, A, c1, c2, *, max_iterations, tolerance, history: int = 10):
    """OWL-QN / L-BFGS on the (convex) CRF objective.

    The reference trains through CRFsuite's ``lbfgs`` algorithm, which
    is L-BFGS when ``c1 == 0`` and OWL-QN (Andrew & Gao 2007) when the
    L1 term is active: the quasi-Newton direction is built from SMOOTH
    gradient differences, steered by the L1 pseudo-gradient, and the
    backtracking line search projects each trial point onto the orthant
    of the expected solution (coordinates that cross zero are zeroed —
    this is what produces genuinely sparse weights, unlike subgradient
    steps).  The padded feature row stays frozen at zero.
    """
    n_state = (A + 1) * 2
    n = n_state + 4
    frozen = numpy.zeros(n, dtype=bool)
    frozen[n_state - 2 : n_state] = True  # padding feature row
    x = numpy.zeros(n, dtype=numpy.float64)

    def smooth(xv):
        f, g = _value_and_grad(xv, idx, y, c2)
        g[frozen] = 0.0
        return f, g

    def full_obj(fval, xv):
        return fval + c1 * numpy.abs(xv).sum()

    def gauge_fix(xv):
        """L1-minimal per-feature gauge: shifting BOTH labels' weights
        of one state feature by a constant leaves every path score —
        and so the likelihood — unchanged; pick the shift that zeroes
        the smaller coordinate.  Valid only when the L2 term (which is
        not gauge-invariant) is off.  This is how the L1 optimum looks
        (one-sided weights, like CRFsuite's); L-BFGS alone stalls in
        these zero-curvature directions."""
        if c1 <= 0 or c2 > 0:
            return xv
        pairs = xv[:n_state].reshape(A + 1, 2).copy()
        w0, w1 = pairs[:, 0], pairs[:, 1]
        m = numpy.where(numpy.abs(w0) <= numpy.abs(w1), w0, w1)
        m[-1] = 0.0
        pairs -= m[:, None]
        out = xv.copy()
        out[:n_state] = pairs.reshape(-1)
        return out

    x = _owlqn_loop(x, smooth, full_obj, c1, frozen, max_iterations,
                    tolerance, history)
    if c1 > 0:
        x2 = gauge_fix(x)
        if not numpy.array_equal(x2, x):
            x = _owlqn_loop(x2, smooth, full_obj, c1, frozen,
                            max_iterations, tolerance, history)
            x = gauge_fix(x)
    state = x[:n_state].reshape(A + 1, 2)
    trans = x[n_state:].reshape(2, 2)
    return state, trans


def _owlqn_loop(x, smooth, full_obj, c1, frozen, max_iterations, tolerance,
                history):
    f, g = smooth(x)
    F = full_obj(f, x)
    S: List["numpy.ndarray"] = []
    Y: List["numpy.ndarray"] = []
    rho: List[float] = []
    for _ in range(max_iterations):
        # pseudo-gradient of f + c1*|x|
        if c1 > 0:
            pg = numpy.where(
                x > 0, g + c1,
                numpy.where(
                    x < 0, g - c1,
                    numpy.where(g + c1 < 0, g + c1,
                                numpy.where(g - c1 > 0, g - c1, 0.0)),
                ),
            )
        else:
            pg = g.copy()
        pg[frozen] = 0.0
        if numpy.max(numpy.abs(pg)) < 1e-10:
            break
        # two-loop recursion on the smooth-gradient history
        d = -pg
        alphas = []
        for s, yk, r in zip(reversed(S), reversed(Y), reversed(rho)):
            a = r * (s @ d)
            alphas.append(a)
            d = d - a * yk
        if Y:
            d = d * ((S[-1] @ Y[-1]) / (Y[-1] @ Y[-1]))
        for s, yk, r, a in zip(S, Y, rho, reversed(alphas)):
            b = r * (yk @ d)
            d = d + (a - b) * s
        if c1 > 0:
            d[d * pg >= 0] = 0.0  # stay in the descent orthant
        if not numpy.any(d):
            break
        # orthant of the expected solution
        xi = numpy.where(x != 0, numpy.sign(x), numpy.sign(-pg))
        dir_deriv = pg @ d
        step = 1.0
        accepted = False
        for _ls in range(30):
            xn = x + step * d
            if c1 > 0:
                xn = numpy.where(xn * xi < 0, 0.0, xn)
            fn, gn = smooth(xn)
            Fn = full_obj(fn, xn)
            if Fn <= F + 1e-4 * step * dir_deriv or Fn < F:
                accepted = True
                break
            step *= 0.5
        if not accepted:
            break
        s = xn - x
        yk = gn - g
        if s @ yk > 1e-10:
            S.append(s)
            Y.append(yk)
            rho.append(1.0 / (s @ yk))
            if len(S) > history:
                S.pop(0)
                Y.pop(0)
                rho.pop(0)
        converged = abs(F - Fn) < tolerance * max(1.0, abs(Fn))
        x, f, g, F = xn, fn, gn, Fn
        if converged:
            break
    return x
