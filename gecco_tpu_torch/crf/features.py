"""Gene ↔ CRF feature/label conversion.

Behavioral reference: ``gecco/crf/features.py`` —
protein-level features group all domains of a gene at one position
(:13-35); domain-level features emit one position per domain (:38-48);
labels threshold probability > 0.5 (:51-71); the annotators are the
inverse mapping (:74-120).
"""

from typing import Dict, Iterable, Iterator, List, Sequence

from ..model import Gene

__all__ = [
    "extract_features_protein",
    "extract_features_domain",
    "extract_labels_protein",
    "extract_labels_domain",
    "annotate_probabilities_protein",
    "annotate_probabilities_domain",
]


def extract_features_protein(sequence: Iterable[Gene], empty: bool = True) -> List[Dict[str, bool]]:
    """One feature dict per gene, keyed by the names of its domains."""
    return [
        {domain.name: True for domain in gene.protein.domains}
        for gene in sequence
        if gene.protein.domains or empty
    ]


def extract_features_domain(sequence: Iterable[Gene], empty: bool = True) -> List[Dict[str, bool]]:
    """One feature dict per domain; unannotated genes emit an empty dict."""
    features: List[Dict[str, bool]] = []
    for gene in sequence:
        if gene.protein.domains:
            features.extend({domain.name: True} for domain in gene.protein.domains)
        elif empty:
            features.append({})
    return features


def extract_labels_protein(sequence: Iterable[Gene], empty: bool = True) -> List[str]:
    return [
        "1" if (gene.average_probability or 0.0) > 0.5 else "0"
        for gene in sequence
        if gene.protein.domains or empty
    ]


def extract_labels_domain(sequence: Iterable[Gene], empty: bool = True) -> List[str]:
    labels: List[str] = []
    for gene in sequence:
        if gene.protein.domains:
            labels.extend(
                "1" if (domain.probability or 0.0) > 0.5 else "0"
                for domain in gene.protein.domains
            )
        elif empty:
            labels.append("1" if (gene.average_probability or 0.0) > 0.5 else "0")
    return labels


def annotate_probabilities_protein(
    sequence: Sequence[Gene],
    probabilities: Sequence[float],
    empty: bool = True,
) -> Iterator[Gene]:
    """Assign one probability per gene (protein-level features)."""
    genes = [gene for gene in sequence if gene.protein.domains or empty]
    if len(genes) != len(probabilities):
        raise ValueError("gene and probability lists don't have the same length")
    for gene, probability in zip(genes, probabilities):
        yield gene.with_probability(float(probability))


def annotate_probabilities_domain(
    sequence: Iterable[Gene],
    probabilities: Iterable[float],
    empty: bool = True,
) -> Iterator[Gene]:
    """Assign one probability per domain (domain-level features)."""
    probas = iter(probabilities)
    for gene in sequence:
        if gene.protein.domains:
            yield gene.with_protein(
                gene.protein.with_domains(
                    [
                        domain.with_probability(float(p))
                        for domain, p in zip(gene.protein.domains, probas)
                    ]
                )
            )
        elif empty:
            yield gene.with_probability(float(next(probas)))
    if next(probas, None) is not None:
        raise ValueError("gene and probability lists don't have the same length")
