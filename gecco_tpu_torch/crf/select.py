"""Feature selection with Fisher's exact test and FDR correction.

Behavioral reference: ``gecco/crf/select.py:30-167`` —
per-domain 2×2 contingency of protein membership in/out of clusters,
two-tailed Fisher exact p-value, then multiple-test correction
(default ``fdr_bh``).  Both the exact test and the corrections are
implemented from scratch (the reference calls scipy/statsmodels).
"""

import collections
import math
from typing import Dict, Iterable, Mapping, Optional

import numpy

from ..model import Protein

__all__ = ["fisher_exact_two_tailed", "significance_correction", "fisher_significance"]

_CORRECTION_METHODS = {"bonferroni", "sidak", "holm", "fdr_bh", "fdr_by"}


def _log_binom(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def fisher_exact_two_tailed(a: int, b: int, c: int, d: int) -> float:
    """Two-tailed Fisher exact test p-value of the 2×2 table [[a,b],[c,d]].

    Sums hypergeometric probabilities of all tables with the same
    margins whose probability does not exceed the observed table's
    (with the conventional (1+1e-7) tolerance, as scipy uses).
    """
    n = a + b + c + d
    row1 = a + b
    col1 = a + c
    log_denominator = _log_binom(n, col1)

    def log_p(x: int) -> float:
        return _log_binom(row1, x) + _log_binom(n - row1, col1 - x) - log_denominator

    lo = max(0, col1 - (n - row1))
    hi = min(row1, col1)
    observed = log_p(a)
    threshold = observed + math.log(1 + 1e-7)
    total = 0.0
    for x in range(lo, hi + 1):
        lp = log_p(x)
        if lp <= threshold:
            total += math.exp(lp)
    return min(1.0, total)


def significance_correction(
    significance: Mapping[str, float], method: str = "fdr_bh"
) -> Dict[str, float]:
    """Multiple-testing correction of a name→p-value map.

    Implements the subset of correction methods GECCO exposes that see
    practical use; ``fdr_bh`` (Benjamini–Hochberg) is the default used
    by ``ClusterCRF.fit``.

    Example:
        >>> s = {"A": 0.6, "B": 0.05, "C": 1, "D": 0}
        >>> sorted((k, round(float(v), 4)) for k, v in significance_correction(s, method="fdr_bh").items())
        [('A', 0.8), ('B', 0.1), ('C', 1.0), ('D', 0.0)]

    """
    if method not in _CORRECTION_METHODS:
        raise ValueError(f"unsupported correction method: {method!r}")
    features = sorted(significance, key=significance.__getitem__)
    p = numpy.array([significance[f] for f in features], dtype=numpy.float64)
    m = len(p)
    if m == 0:
        return {}
    if method == "bonferroni":
        corrected = numpy.minimum(p * m, 1.0)
    elif method == "sidak":
        corrected = 1.0 - numpy.power(1.0 - p, m)
    elif method == "holm":
        adjusted = p * (m - numpy.arange(m))
        corrected = numpy.minimum(numpy.maximum.accumulate(adjusted), 1.0)
    elif method in ("fdr_bh", "fdr_by"):
        scale = 1.0 if method == "fdr_bh" else numpy.sum(1.0 / numpy.arange(1, m + 1))
        ranked = p * m * scale / numpy.arange(1, m + 1)
        corrected = numpy.minimum(numpy.minimum.accumulate(ranked[::-1])[::-1], 1.0)
    return dict(zip(features, corrected))


def fisher_significance(
    proteins: Iterable[Protein],
    correction_method: Optional[str] = "fdr_bh",
) -> Dict[str, float]:
    """Two-tailed Fisher significance of every domain for cluster membership.

    Domains must carry a probability (1 in-cluster / 0 out); the
    contingency counts *proteins* containing each domain on each side.

    Example:
        >>> from gecco_tpu_torch.model import Domain
        >>> mk = lambda i, names, p: Protein(f"prot{i}", "", [
        ...     Domain(n, 1, 2, "Pfam", 0.0, 0.0, probability=p) for n in names])
        >>> data = [mk(1, "AB", 1), mk(2, "AB", 1), mk(3, "AB", 1),
        ...         mk(4, "A", 1), mk(5, "A", 1), mk(6, "CB", 0), mk(7, "C", 0)]
        >>> sorted((k, round(float(v), 3)) for k, v in fisher_significance(data).items())
        [('A', 0.071), ('B', 1.0), ('C', 0.071)]

    """
    proteins_ = {True: set(), False: set()}
    features_ = {True: collections.defaultdict(set), False: collections.defaultdict(set)}
    for protein in proteins:
        for domain in protein.domains:
            if domain.probability is None:
                raise ValueError("Domain is missing a gene cluster probability")
            in_cluster = domain.probability > 0.5
            proteins_[in_cluster].add(protein.id)
            features_[in_cluster][domain.name].add(protein.id)

    significance = {}
    # sorted union: p-value ties are broken by insertion order further
    # down, and set iteration order varies with PYTHONHASHSEED — a
    # seeded training run must be reproducible across processes
    for feature in sorted(set(features_[False]).union(features_[True])):
        significance[feature] = fisher_exact_two_tailed(
            len(features_[True][feature]),
            len(proteins_[True]) - len(features_[True][feature]),
            len(features_[False][feature]),
            len(proteins_[False]) - len(features_[False][feature]),
        )
    if correction_method is not None:
        significance = significance_correction(significance, correction_method)
    return significance
