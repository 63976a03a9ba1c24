"""Segment per-gene CRF probabilities into candidate gene clusters.

Behavioral reference: ``gecco/refine.py`` —
``BIO_PFAMS`` (:23-47), ``GeneGrouper`` threshold grouper that carries
state across unannotated genes (:51-64), ``ClusterRefiner`` with the
``gecco``/``antismash`` validation criteria, edge-distance filter and
unannotated-edge trimming (:68-200).
"""

import itertools
import operator
from typing import Iterator, List, Tuple

import numpy

from .model import Cluster, Gene

__all__ = ["BIO_PFAMS", "GeneGrouper", "ClusterRefiner"]

# Pfam domains considered "biosynthetic" by AntiSMASH (130 unique
# accessions, used by the `antismash` validation criterion).
BIO_PFAMS = frozenset({
    "PF00109", "PF02801", "PF08659", "PF00378", "PF08541", "PF08545",
    "PF02803", "PF00108", "PF02706", "PF03364", "PF08990", "PF00501",
    "PF00668", "PF08415", "PF00975", "PF03061", "PF00432", "PF00494",
    "PF03936", "PF01397", "PF00432", "PF04275", "PF00348", "PF02401",
    "PF04551", "PF00368", "PF00534", "PF00535", "PF02922", "PF01041",
    "PF00128", "PF00908", "PF02719", "PF04321", "PF01943", "PF02806",
    "PF02350", "PF02397", "PF04932", "PF01075", "PF00953", "PF01050",
    "PF03033", "PF01501", "PF05159", "PF04101", "PF02563", "PF08437",
    "PF02585", "PF01721", "PF02052", "PF02674", "PF03515", "PF04369",
    "PF08109", "PF08129", "PF09221", "PF09683", "PF10439", "PF11420",
    "PF11632", "PF11758", "PF12173", "PF04738", "PF04737", "PF04604",
    "PF05147", "PF08109", "PF08129", "PF08130", "PF00155", "PF00202",
    "PF00702", "PF06339", "PF04183", "PF10331", "PF03756", "PF00106",
    "PF01370", "PF00107", "PF08240", "PF00441", "PF02770", "PF02771",
    "PF08028", "PF01408", "PF02894", "PF00984", "PF00725", "PF03720",
    "PF03721", "PF07993", "PF02737", "PF00903", "PF00037", "PF04055",
    "PF00171", "PF00067", "PF01266", "PF01118", "PF02668", "PF00248",
    "PF01494", "PF01593", "PF03992", "PF00355", "PF01243", "PF00384",
    "PF01488", "PF00857", "PF04879", "PF08241", "PF08242", "PF00698",
    "PF00483", "PF00561", "PF00583", "PF01636", "PF01039", "PF00288",
    "PF00289", "PF02786", "PF01757", "PF02785", "PF02409", "PF01553",
    "PF02348", "PF00891", "PF01596", "PF04820", "PF02522", "PF08484",
    "PF08421",
})


class GeneGrouper:
    """A stateful threshold predicate for `itertools.groupby`.

    Genes without a probability inherit the in/out-cluster state of the
    previous gene, so unannotated genes inside a probability run do not
    split the cluster.
    """

    def __init__(self, threshold: float) -> None:
        self.in_cluster = False
        self.threshold = threshold

    def __call__(self, gene: Gene) -> bool:
        if gene.average_probability is not None:
            self.in_cluster = gene.average_probability > self.threshold
        return self.in_cluster


class ClusterRefiner:
    """Extracts and validates contiguous clusters from CRF predictions."""

    def __init__(
        self,
        *,
        threshold: float = 0.8,
        criterion: str = "gecco",
        n_cds: int = 5,
        n_biopfams: int = 5,
        average_threshold: float = 0.6,
        edge_distance: int = 0,
        trim: bool = True,
    ) -> None:
        self.threshold = threshold
        self.criterion = criterion
        self.n_cds = n_cds
        self.n_biopfams = n_biopfams
        self.average_threshold = average_threshold
        self.edge_distance = edge_distance
        self.trim = trim

    def iter_clusters(self, genes: List[Gene]) -> Iterator[Cluster]:
        """Yield valid clusters from probability-annotated genes."""
        for seq, cluster in self._iter_segments(genes):
            if self.trim:
                cluster = self._trim_cluster(cluster)
            if self._validate_cluster(seq, cluster):
                yield cluster

    def _validate_cluster(self, seq: List[Gene], cluster: Cluster) -> bool:
        if self.criterion == "gecco":
            annotated = [g for g in cluster.genes if g.protein.domains]
            cds_criterion = len(annotated) >= self.n_cds
            if self.edge_distance > 0:
                annotated_ids = [g.id for g in seq if g.protein.domains]
                edge_genes = set(annotated_ids[: self.edge_distance]).union(
                    annotated_ids[-self.edge_distance :]
                )
            else:
                edge_genes = set()
            # the edge criterion counts *all* cluster genes away from the
            # edges, mirroring the reference compatibility note
            # (refine.py:153-157)
            edge_criterion = (
                len({g.id for g in cluster.genes}.difference(edge_genes)) >= self.n_cds
            )
            return cds_criterion and edge_criterion
        if self.criterion == "antismash":
            domains = {d.name for g in cluster.genes for d in g.protein.domains}
            p_criterion = (
                numpy.mean([g.average_probability for g in cluster.genes])
                >= self.average_threshold
            )
            bio_criterion = len(domains & BIO_PFAMS) >= self.n_biopfams
            cds_criterion = len(cluster.genes) >= self.n_cds
            return bool(p_criterion and bio_criterion and cds_criterion)
        raise ValueError(f"Unknown cluster filtering criterion: {self.criterion}")

    def _trim_cluster(self, cluster: Cluster) -> Cluster:
        """Drop unannotated genes from both cluster edges."""
        genes = list(cluster.genes)
        while genes and not genes[0].protein.domains:
            genes.pop(0)
        while genes and not genes[-1].protein.domains:
            genes.pop()
        return Cluster(cluster.id, genes, cluster.type, cluster.type_probabilities)

    def _iter_segments(self, genes: List[Gene]) -> Iterator[Tuple[List[Gene], Cluster]]:
        key = operator.attrgetter("source.id")
        grouper = GeneGrouper(self.threshold)
        for seq_id, sequence in itertools.groupby(sorted(genes, key=key), key=key):
            ordered = sorted(sequence, key=operator.attrgetter("start", "end"))
            groups = itertools.groupby(ordered, key=grouper)
            runs = (group for in_cluster, group in groups if in_cluster)
            for i, run in enumerate(runs):
                yield ordered, Cluster(id=f"{seq_id}_cluster_{i+1}", genes=list(run))
