"""Random-forest storage, inference, and from-scratch training.

The reference delegates to ``sklearn.ensemble.RandomForestClassifier``
(``gecco/types/__init__.py:90-105,121``) re-fitted at
load time; here the frozen forest ships as flat arrays
(``gecco_tpu_torch/data/forest.npz``, see ``tools/export_forest.py``) and both
inference and (re)training are implemented in this package.
"""

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy

__all__ = ["Forest", "train_forest"]

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")


@dataclass
class Forest:
    """A multi-output random forest stored as flat node arrays."""

    children_left: "numpy.ndarray"   # [n_nodes] int32, -1 at leaves
    children_right: "numpy.ndarray"  # [n_nodes] int32
    feature: "numpy.ndarray"         # [n_nodes] int32
    threshold: "numpy.ndarray"       # [n_nodes] float64
    value: "numpy.ndarray"           # [n_nodes, n_outputs] P(class 0) — the
                                     # reference computes positives as
                                     # 1 - P(class 0) (types/__init__.py:125-128)
                                     # and matching that order keeps the
                                     # averaged output bit-equal to sklearn
    tree_offsets: "numpy.ndarray"    # [n_trees + 1] int64
    classes: List[str]
    domains: List[str]

    @classmethod
    def load(cls, path: Optional[str] = None) -> "Forest":
        if path is None:
            path = os.path.join(_DATA_DIR, "forest.npz")
        payload = numpy.load(path, allow_pickle=True)
        return cls(
            children_left=payload["children_left"],
            children_right=payload["children_right"],
            feature=payload["feature"],
            threshold=payload["threshold"],
            value=payload["value"],
            tree_offsets=payload["tree_offsets"],
            classes=[str(x) for x in payload["classes"]],
            domains=[str(x) for x in payload["domains"]],
        )

    def save(self, path: str) -> None:
        numpy.savez_compressed(
            path,
            children_left=self.children_left,
            children_right=self.children_right,
            feature=self.feature,
            threshold=self.threshold,
            value=self.value,
            tree_offsets=self.tree_offsets,
            classes=numpy.array(self.classes, dtype=object),
            domains=numpy.array(self.domains, dtype=object),
        )

    @property
    def n_trees(self) -> int:
        return len(self.tree_offsets) - 1

    @property
    def n_outputs(self) -> int:
        return self.value.shape[1]

    def predict_proba(self, x: "numpy.ndarray") -> "numpy.ndarray":
        """Positive-class probabilities, ``[n_samples, n_outputs]``.

        Averages per-tree leaf distributions like sklearn's
        ``predict_proba`` (vectorized over samples; each tree walked with
        a frontier of node indices).  Inputs are cast to float32 before
        the threshold comparisons — sklearn's tree code does the same,
        and matching it makes the walk bit-equal to the reference's
        re-fitted ``RandomForestClassifier(random_state=0)``.
        """
        x = numpy.asarray(x, dtype=numpy.float32)
        n = x.shape[0]
        total = numpy.zeros((n, self.n_outputs), dtype=numpy.float64)
        left, right = self.children_left, self.children_right
        feature, threshold = self.feature, self.threshold
        for t in range(self.n_trees):
            root = int(self.tree_offsets[t])
            nodes = numpy.full(n, root, dtype=numpy.int64)
            active = left[nodes] != -1
            while active.any():
                idx = nodes[active]
                go_left = x[active, feature[idx]] <= threshold[idx]
                nodes[active] = numpy.where(go_left, left[idx], right[idx])
                active = left[nodes] != -1
            total += self.value[nodes]
        return 1.0 - total / self.n_trees


def _gini_best_split(
    x: "numpy.ndarray",
    y: "numpy.ndarray",
    feature_indices: "numpy.ndarray",
):
    """Best (feature, threshold) by mean multi-output Gini impurity decrease."""
    n, _ = x.shape
    best = (None, None, 0.0)
    parent_p = y.mean(axis=0)
    parent_gini = numpy.mean(2 * parent_p * (1 - parent_p))
    for f in feature_indices:
        order = numpy.argsort(x[:, f], kind="stable")
        xs = x[order, f]
        ys = y[order]
        cum = numpy.cumsum(ys, axis=0)
        totals = cum[-1]
        boundaries = numpy.nonzero(xs[1:] > xs[:-1])[0]
        if len(boundaries) == 0:
            continue
        k = boundaries + 1  # left sizes
        left_p = cum[boundaries] / k[:, None]
        right_p = (totals[None, :] - cum[boundaries]) / (n - k)[:, None]
        gini_left = numpy.mean(2 * left_p * (1 - left_p), axis=1)
        gini_right = numpy.mean(2 * right_p * (1 - right_p), axis=1)
        weighted = (k * gini_left + (n - k) * gini_right) / n
        i = int(numpy.argmin(weighted))
        gain = parent_gini - weighted[i]
        if gain > best[2] + 1e-15:
            threshold = (xs[boundaries[i]] + xs[boundaries[i] + 1]) / 2.0
            best = (int(f), float(threshold), float(gain))
    return best


def train_forest(
    x: "numpy.ndarray",
    y: "numpy.ndarray",
    classes: Sequence[str],
    domains: Sequence[str],
    n_trees: int = 100,
    max_features: str = "sqrt",
    seed: int = 0,
    min_samples_leaf: int = 1,
    min_samples_split: int = 2,
) -> Forest:
    """Train a multi-output random forest from scratch (deterministic).

    CART with Gini impurity averaged over outputs, bootstrap sampling,
    sqrt-feature subsampling per split — the same algorithm family as the
    sklearn classifier the reference uses, implemented independently (the
    exact trees differ; accuracy is validated in tests against the
    exported reference forest).
    """
    # fit on float32 features like sklearn's tree code: inference casts
    # inputs to f32, so thresholds chosen between f64-distinct values
    # that collapse in f32 would route training samples inconsistently
    x = numpy.asarray(x, dtype=numpy.float32).astype(numpy.float64)
    y = numpy.asarray(y, dtype=numpy.float64)
    n, d = x.shape
    n_sub = max(1, int(numpy.sqrt(d))) if max_features == "sqrt" else d
    rng = numpy.random.default_rng(seed)

    lefts: List[int] = []
    rights: List[int] = []
    feats: List[int] = []
    thresholds: List[float] = []
    values: List["numpy.ndarray"] = []
    offsets = [0]

    def build(xs, ys, depth) -> int:
        node = len(lefts)
        lefts.append(-1)
        rights.append(-1)
        feats.append(-2)
        thresholds.append(-2.0)
        values.append(1.0 - ys.mean(axis=0))
        if len(xs) < min_samples_split or (ys.min(axis=0) == ys.max(axis=0)).all():
            return node
        feature_indices = rng.choice(d, size=n_sub, replace=False)
        f, threshold, gain = _gini_best_split(xs, ys, feature_indices)
        if f is None or gain <= 0:
            return node
        mask = xs[:, f] <= threshold
        if mask.sum() < min_samples_leaf or (~mask).sum() < min_samples_leaf:
            return node
        feats[node] = f
        thresholds[node] = threshold
        lefts[node] = build(xs[mask], ys[mask], depth + 1)
        rights[node] = build(xs[~mask], ys[~mask], depth + 1)
        return node

    import sys

    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 100000))
    try:
        for _ in range(n_trees):
            sample = rng.integers(0, n, size=n)
            build(x[sample], y[sample], 0)
            offsets.append(len(lefts))
    finally:
        sys.setrecursionlimit(limit)

    return Forest(
        children_left=numpy.array(lefts, dtype=numpy.int32),
        children_right=numpy.array(rights, dtype=numpy.int32),
        feature=numpy.array(feats, dtype=numpy.int32),
        threshold=numpy.array(thresholds, dtype=numpy.float64),
        value=numpy.stack(values).astype(numpy.float64),
        tree_offsets=numpy.array(offsets, dtype=numpy.int64),
        classes=list(classes),
        domains=list(domains),
    )
