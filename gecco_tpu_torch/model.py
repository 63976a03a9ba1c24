"""Core data model: genes, proteins, domains, clusters, and their tables.

Behavioral reference: ``gecco/model.py`` —
``ClusterType`` (:52-93), ``Strand`` (:96-107), ``Domain`` (:110-196),
``Protein`` (:199-237), ``Gene`` (:240-387), ``Cluster`` (:390-595),
``FeatureTable`` (:621-706), ``ClusterTable`` (:709-770), ``GeneTable``
(:773-835).  Implementation is from scratch on top of
``gecco_tpu_torch.seq`` / ``gecco_tpu_torch.tables``.
"""

import collections
import datetime
import enum
import math
import operator
import statistics
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

import numpy

from . import __version__
from .interpro import GOTerm
from .seq import FeatureLocation, Seq, SeqFeature, SeqRecord, UnknownSeq
from .tables import Column, Table

__all__ = [
    "ClusterType",
    "Strand",
    "Domain",
    "Protein",
    "Gene",
    "Cluster",
    "FeatureTable",
    "ClusterTable",
    "GeneTable",
]


class ClusterType(object):
    """An immutable set-of-names cluster type.

    Example:
        >>> t1 = ClusterType()                    # unknown type
        >>> t2 = ClusterType("Polyketide")        # single type
        >>> t3 = ClusterType("Polyketide", "NRP") # multiple types
        >>> str(t3)
        'NRP;Polyketide'

    """

    def __init__(self, *names: str) -> None:
        self.names = frozenset(names)

    def __repr__(self) -> str:
        return "ClusterType({})".format(", ".join(map(repr, sorted(self.names))))

    def __str__(self) -> str:
        return "Unknown" if not self else ";".join(sorted(self.names))

    def __hash__(self) -> int:
        return hash(self.names)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, ClusterType):
            return NotImplemented
        return self.names == other.names

    def __bool__(self) -> bool:
        return len(self.names) != 0

    def unpack(self) -> List["ClusterType"]:
        """Split a composite type into single-name types, sorted.

        Example:
            >>> ty = ClusterType("Polyketide", "Saccharide")
            >>> ty.unpack()
            [ClusterType('Polyketide'), ClusterType('Saccharide')]

        """
        return [ClusterType(name) for name in sorted(self.names)]


class Strand(enum.IntEnum):
    """DNA strand of a gene: ``Coding`` (+1) or ``Reverse`` (-1)."""

    Coding = 1
    Reverse = -1

    @property
    def sign(self) -> str:
        return "+" if self is Strand.Coding else "-"


@dataclass(frozen=True)
class Domain:
    """A conserved region within a protein (1-based inclusive coordinates)."""

    name: str
    start: int
    end: int
    hmm: str
    i_evalue: float
    pvalue: float
    probability: Optional[float] = None
    cluster_weight: Optional[float] = None
    go_terms: List[GOTerm] = field(default_factory=list)
    go_functions: List[GOTerm] = field(default_factory=list)
    qualifiers: Dict[str, List[str]] = field(default_factory=dict)

    def with_probability(self, probability: Optional[float]) -> "Domain":
        return Domain(
            self.name, self.start, self.end, self.hmm, self.i_evalue, self.pvalue,
            probability, self.cluster_weight, self.go_terms, self.go_functions,
            dict(self.qualifiers),
        )

    def with_cluster_weight(self, cluster_weight: Optional[float]) -> "Domain":
        return Domain(
            self.name, self.start, self.end, self.hmm, self.i_evalue, self.pvalue,
            self.probability, cluster_weight, self.go_terms, self.go_functions,
            dict(self.qualifiers),
        )

    def to_seq_feature(self, protein_coordinates: bool = False) -> SeqFeature:
        """Render as a ``misc_feature`` (nucleotide coords unless told otherwise)."""
        stride = 1 if protein_coordinates else 3
        location = FeatureLocation((self.start - 1) * stride, self.end * stride)
        qualifiers = {k: list(v) for k, v in self.qualifiers.items()}
        qualifiers.setdefault("standard_name", [self.name])
        for go_term in self.go_terms:
            qualifiers.setdefault("db_xref", []).append(go_term.accession)
        return SeqFeature(location=location, type="misc_feature", qualifiers=qualifiers)


@dataclass(frozen=True)
class Protein:
    """A protein with its identifier, sequence, and annotated domains."""

    id: str
    seq: Seq
    domains: List[Domain] = field(default_factory=list)

    def to_seq_record(self) -> SeqRecord:
        return SeqRecord(id=self.id, name=self.id, seq=self.seq)

    def with_seq(self, seq: Seq) -> "Protein":
        return Protein(self.id, seq, list(self.domains))

    def with_domains(self, domains: Iterable[Domain]) -> "Protein":
        return Protein(self.id, self.seq, list(domains))


# MIBiG-derived color palette for GenBank visualization, keyed by GO
# function family and ordered by priority (``gecco/model.py:294-316``).
_FUNCTION_PALETTE = OrderedDict([
    ("transporter activity", (0x64, 0x95, 0xED)),
    ("cargo receptor activity", (0x64, 0x95, 0xED)),
    ("molecular carrier activity", (0x64, 0x95, 0xED)),
    ("translation regulator activity", (0x2E, 0x8B, 0x56)),
    ("molecular function regulator activity", (0x2E, 0x8B, 0x56)),
    ("transcription regulator activity", (0x2E, 0x8B, 0x56)),
    ("regulation of molecular function", (0x2E, 0x8B, 0x56)),
    ("general transcription initiation factor activity", (0x2E, 0x8B, 0x56)),
    ("toxin activity", (0x81, 0x0E, 0x15)),
    ("catalytic activity", (0x81, 0x0E, 0x15)),
    ("biosynthetic activity", (0xF1, 0x6D, 0x75)),
    ("non-biosynthetic activity", (0xBD, 0xB7, 0x6B)),
    ("unknown", (0x80, 0x80, 0x80)),
])


@dataclass(frozen=True)
class Gene:
    """A protein-coding gene (1-based inclusive nucleotide coordinates)."""

    source: SeqRecord
    start: int
    end: int
    strand: Strand
    protein: Protein
    qualifiers: Dict[str, List[str]] = field(default_factory=dict)
    _probability: Optional[float] = field(default_factory=lambda: None)

    @property
    def id(self) -> str:
        return self.protein.id

    @property
    def average_probability(self) -> Optional[float]:
        if self._probability is not None:
            return self._probability
        p = [d.probability for d in self.protein.domains if d.probability is not None]
        return statistics.mean(p) if p else None

    @property
    def maximum_probability(self) -> Optional[float]:
        if self._probability is not None:
            return self._probability
        p = [d.probability for d in self.protein.domains if d.probability is not None]
        return max(p) if p else None

    def functions(self) -> Set[str]:
        """Names of GO function families over all annotated domains."""
        functions = {
            term.name
            for domain in self.protein.domains
            for term in domain.go_functions
        }
        if not functions:
            functions.add("unknown")
        return functions

    def to_seq_feature(self, color: bool = True) -> SeqFeature:
        """Render as a ``CDS`` feature (0-based end-exclusive location)."""
        location = FeatureLocation(self.start, self.end + 1, int(self.strand))
        qualifiers = {k: list(v) for k, v in self.qualifiers.items()}
        qualifiers.setdefault("locus_tag", [self.protein.id])
        qualifiers.setdefault("translation", [str(self.protein.seq)])
        functions = self.functions()
        qualifiers.setdefault("function", sorted(functions))
        if color:
            for name, rgb in _FUNCTION_PALETTE.items():
                if name in functions:
                    break
            else:
                rgb = _FUNCTION_PALETTE["unknown"]
            qualifiers.setdefault("colour", [" ".join(str(x) for x in rgb)])
            qualifiers.setdefault("ApEinfo_fwdcolor", ["#{:02x}{:02x}{:02x}".format(*rgb)])
            qualifiers.setdefault("ApEinfo_revcolor", ["#{:02x}{:02x}{:02x}".format(*rgb)])
        return SeqFeature(location=location, type="CDS", qualifiers=qualifiers)

    def with_protein(self, protein: Protein) -> "Gene":
        return Gene(
            self.source, self.start, self.end, self.strand, protein,
            dict(self.qualifiers), _probability=self._probability,
        )

    def with_source(self, source: SeqRecord) -> "Gene":
        return Gene(
            source, self.start, self.end, self.strand, self.protein,
            dict(self.qualifiers), _probability=self._probability,
        )

    def with_probability(self, probability: float) -> "Gene":
        return Gene(
            self.source, self.start, self.end, self.strand,
            self.protein.with_domains(
                [d.with_probability(probability) for d in self.protein.domains]
            ),
            dict(self.qualifiers), _probability=probability,
        )


@dataclass
class Cluster:
    """A contiguous run of genes predicted to form a gene cluster."""

    id: str
    genes: List[Gene]
    type: Optional[ClusterType]
    type_probabilities: Dict[str, float]

    def __init__(
        self,
        id: str,
        genes: Optional[List[Gene]] = None,
        type: Optional[ClusterType] = None,
        type_probabilities: Optional[Dict[str, float]] = None,
    ) -> None:
        self.id = id
        self.genes = genes or []
        self.type = type
        self.type_probabilities = type_probabilities or {}

    @property
    def source(self) -> SeqRecord:
        return self.genes[0].source

    @property
    def start(self) -> int:
        return min(gene.start for gene in self.genes)

    @property
    def end(self) -> int:
        return max(gene.end for gene in self.genes)

    @property
    def average_probability(self) -> Optional[float]:
        p = [g.average_probability for g in self.genes if g.average_probability is not None]
        return statistics.mean(p) if p else None

    @property
    def maximum_probability(self) -> Optional[float]:
        p = [g.maximum_probability for g in self.genes if g.maximum_probability is not None]
        return max(p) if p else None

    def domain_composition(
        self,
        all_possible: Optional[Sequence[str]] = None,
        normalize: bool = True,
        minlog_weights: bool = False,
        pvalue: bool = True,
    ) -> "numpy.ndarray":
        """Weighted domain composition vector over ``all_possible`` names.

        Each domain contributes ``1 - v`` (or ``-log10(v)`` when
        ``minlog_weights``) where ``v`` is its p-value (or i-evalue when
        ``pvalue=False``); contributions with the same name are summed and
        the vector is optionally L1-normalized
        (``gecco/model.py:458-503``).
        """
        domains = [d for gene in self.genes for d in gene.protein.domains]
        names = [d.name for d in domains]
        get = operator.attrgetter("pvalue" if pvalue else "i_evalue")
        if minlog_weights:
            weights = numpy.array([-math.log10(get(d)) for d in domains])
        else:
            weights = numpy.array([1.0 - get(d) for d in domains])
        if all_possible is None:
            all_possible = sorted(set(names))
        totals: Dict[str, float] = collections.defaultdict(float)
        for name, weight in zip(names, weights):
            totals[name] += weight
        composition = numpy.array([totals.get(name, 0.0) for name in all_possible], dtype=numpy.float64)
        if normalize:
            return composition / (composition.sum() or 1.0)
        return composition

    def to_seq_record(self) -> SeqRecord:
        """Build a GenBank-ready record: sliced source + CDS/misc features.

        Replicates the reference record layout (``gecco/model.py:507-595``):
        cluster-sliced sequence, GECCO-Data structured comment with type
        probabilities, CDS features per gene and misc_features per domain
        (domain coordinates mapped through the gene strand).
        """
        now = datetime.datetime.now()
        record = self.source[self.start - 1 : self.end]
        record.id = record.name = self.id
        record.annotations = dict(self.source.annotations)
        record.annotations["topology"] = "linear"
        record.annotations["molecule_type"] = "DNA"
        record.annotations["date"] = now.strftime("%d-%b-%Y").upper()

        reference = {
            "title": "Accurate de novo identification of biosynthetic gene clusters with GECCO",
            "journal": "bioRxiv (2021.05.03.442509)",
            "comment": "doi:10.1101/2021.05.03.442509",
            "authors": ", ".join([
                "Laura M Carroll",
                "Martin Larralde",
                "Jonas Simon Fleck",
                "Ruby Ponnudurai",
                "Alessio Milanese",
                "Elisa Cappio Barazzone",
                "Georg Zeller",
            ]),
        }
        record.annotations.setdefault("references", []).append(reference)  # type: ignore[union-attr]

        if self.type is not None:
            cluster_type = {"cluster_type": ";".join(sorted(self.type.names)) or "Unknown"}
            probabilities = {
                f"{key.lower()}_probability": f"{value:.3f}"
                for key, value in self.type_probabilities.items()
            }
        else:
            cluster_type = probabilities = {}

        structured = record.annotations.setdefault("structured_comment", OrderedDict())
        structured["GECCO-Data"] = {  # type: ignore[index]
            "version": f"GECCO v{__version__}",
            "creation_date": now.isoformat(),
            **cluster_type,
            **probabilities,
        }

        for gene in self.genes:
            cds = gene.to_seq_feature()
            cds.location += -self.start
            record.features.append(cds)
            for domain in gene.protein.domains:
                misc = domain.to_seq_feature(protein_coordinates=False)
                if gene.strand == Strand.Coding:
                    misc.location = FeatureLocation(
                        cds.location.start + misc.location.start,
                        cds.location.start + misc.location.end,
                    )
                else:
                    misc.location = FeatureLocation(
                        cds.location.end - misc.location.end,
                        cds.location.end - misc.location.start,
                    )
                record.features.append(misc)
        return record


class FeatureTable(Table):
    """Per-domain annotation rows (``features.tsv``)."""

    @classmethod
    def _get_columns(cls) -> List[Column]:
        return [
            Column("sequence_id", str),
            Column("protein_id", str),
            Column("start", int),
            Column("end", int),
            Column("strand", str),
            Column("domain", str),
            Column("hmm", str),
            Column("i_evalue", float),
            Column("pvalue", float),
            Column("domain_start", int),
            Column("domain_end", int),
            Column("cluster_probability", float, default=math.nan),
        ]

    @classmethod
    def from_genes(cls, genes: Iterable[Gene]) -> "FeatureTable":
        data: Dict[str, list] = collections.defaultdict(list)
        for gene in genes:
            for domain in gene.protein.domains:
                data["sequence_id"].append(gene.source.id)
                data["protein_id"].append(gene.protein.id)
                data["start"].append(gene.start)
                data["end"].append(gene.end)
                data["strand"].append(gene.strand.sign)
                data["domain"].append(domain.name)
                data["hmm"].append(domain.hmm)
                data["i_evalue"].append(domain.i_evalue)
                data["pvalue"].append(domain.pvalue)
                data["domain_start"].append(domain.start)
                data["domain_end"].append(domain.end)
                data["cluster_probability"].append(
                    math.nan if domain.probability is None else domain.probability
                )
        return cls(dict(data))

    def to_genes(self) -> Iterator[Gene]:
        """Group rows into genes (dummy source sequences), sorted by protein id."""
        indices: Dict[str, List[int]] = collections.defaultdict(list)
        for i, protein_id in enumerate(self.protein_id):
            indices[protein_id].append(i)
        for protein_id in sorted(indices):
            rows = indices[protein_id]
            first = rows[0]
            for i in rows:
                if (
                    self.sequence_id[i] != self.sequence_id[first]
                    or self.start[i] != self.start[first]
                    or self.end[i] != self.end[first]
                ):
                    raise ValueError(f"inconsistent rows for protein {protein_id!r}")
            source = SeqRecord(id=self.sequence_id[first], seq=UnknownSeq())
            strand = Strand.Coding if self.strand[first] == "+" else Strand.Reverse
            protein = Protein(protein_id, seq=UnknownSeq())
            gene = Gene(source, self.start[first], self.end[first], strand, protein)
            for i in rows:
                probability = self.cluster_probability[i]
                gene.protein.domains.append(
                    Domain(
                        self.domain[i],
                        self.domain_start[i],
                        self.domain_end[i],
                        self.hmm[i],
                        self.i_evalue[i],
                        self.pvalue[i],
                        None if (isinstance(probability, float) and math.isnan(probability)) else probability,
                    )
                )
            yield gene


class ClusterTable(Table):
    """Per-cluster summary rows (``clusters.tsv``); always writes all columns."""

    _KEEP_ALL_COLUMNS = True

    @classmethod
    def _get_columns(cls) -> List[Column]:
        return [
            Column("sequence_id", str),
            Column("cluster_id", str),
            Column("start", int),
            Column("end", int),
            Column("average_p", float, default=math.nan),
            Column("max_p", float, default=math.nan),
            Column("type", str, default="Unknown"),
            # dynamic per-type probability columns are appended by from_clusters
            Column("proteins", str, default=""),
            Column("domains", str, default=""),
        ]

    @classmethod
    def from_clusters(cls, clusters: Iterable[Cluster]) -> "ClusterTable":
        data: Dict[str, list] = collections.defaultdict(list)
        for cluster in clusters:
            data["sequence_id"].append(cluster.source.id)
            data["cluster_id"].append(cluster.id)
            data["start"].append(cluster.start)
            data["end"].append(cluster.end)
            average = cluster.average_probability
            maximum = cluster.maximum_probability
            data["average_p"].append(math.nan if average is None else average)
            data["max_p"].append(math.nan if maximum is None else maximum)
            if cluster.type is not None:
                data["type"].append(str(cluster.type))
                for name in sorted(cluster.type_probabilities, key=str.casefold):
                    data[f"{name.lower()}_probability"].append(cluster.type_probabilities[name])
            # NB: matches the shipped goldens (tests/test_cli/data/*.clusters.tsv):
            # proteins in gene order, domains unique and sorted
            data["proteins"].append(";".join(g.protein.id for g in cluster.genes))
            data["domains"].append(";".join(sorted(
                {d.name for g in cluster.genes for d in g.protein.domains}
            )))
        table = cls(dict(data))
        # keep the dynamic probability columns between `type` and `proteins`
        order = [c.name for c in cls._get_columns()]
        head = order[: order.index("proteins")]
        tail = order[order.index("proteins"):]
        extras = [n for n in table.columns if n not in order]
        table._data = {
            name: table._data[name] for name in head + sorted(extras) + tail
        }
        return table


class GeneTable(Table):
    """Per-gene coordinate rows with probabilities (``genes.tsv``)."""

    @classmethod
    def _get_columns(cls) -> List[Column]:
        return [
            Column("sequence_id", str),
            Column("protein_id", str),
            Column("start", int),
            Column("end", int),
            Column("strand", str),
            Column("average_p", float, default=math.nan),
            Column("max_p", float, default=math.nan),
        ]

    @classmethod
    def from_genes(cls, genes: Iterable[Gene]) -> "GeneTable":
        data: Dict[str, list] = collections.defaultdict(list)
        for gene in genes:
            data["sequence_id"].append(gene.source.id)
            data["protein_id"].append(gene.protein.id)
            data["start"].append(gene.start)
            data["end"].append(gene.end)
            data["strand"].append(gene.strand.sign)
            average = gene.average_probability
            maximum = gene.maximum_probability
            data["average_p"].append(math.nan if average is None else average)
            data["max_p"].append(math.nan if maximum is None else maximum)
        return cls(dict(data))

    def to_genes(self) -> Iterator[Gene]:
        has_probabilities = "average_p" in self.columns
        for i, protein_id in enumerate(self.protein_id):
            source = SeqRecord(id=self.sequence_id[i], seq=UnknownSeq())
            strand = Strand.Coding if self.strand[i] == "+" else Strand.Reverse
            start, end = self.start[i], self.end[i]
            protein = Protein(protein_id, seq=Seq("X" * ((end - start) // 3)))
            probability = self.average_p[i] if has_probabilities else None
            if isinstance(probability, float) and math.isnan(probability):
                probability = None
            yield Gene(source, start, end, strand, protein, _probability=probability)
