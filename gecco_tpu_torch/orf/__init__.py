"""Gene calling: extract protein-coding genes from DNA records.

Behavioral reference: ``gecco/orf.py`` —
``ORFFinder`` ABC (:29-41), ``CDSFinder`` (:149-201), ``GFFFinder``
(:204-263), ``PyrodigalFinder`` (:44-146).  The Prodigal-equivalent
de-novo finder is implemented from scratch in ``gecco_tpu_torch.orf.scan``
(``ScanFinder``); ``CDSFinder``/``GFFFinder`` extract existing
annotations on the host.
"""

import abc
import warnings
from typing import Callable, Dict, Iterable, Iterator, List, Optional

from ..model import Gene, Protein, Strand
from ..seq import FeatureLocation, Seq, SeqFeature, SeqRecord

__all__ = ["ORFFinder", "CDSFinder", "GFFFinder", "ScanFinder"]


class ORFFinder(metaclass=abc.ABCMeta):
    """An abstract base class for ORF finders."""

    @abc.abstractmethod
    def find_genes(
        self,
        records: Iterable[SeqRecord],
        progress: Optional[Callable[[SeqRecord, int], None]] = None,
    ) -> Iterable[Gene]:
        """Find all genes in the given DNA records."""
        return NotImplemented


class CDSFinder(ORFFinder):
    """Extracts existing ``CDS`` features from annotated records.

    Uses the ``translation`` qualifier when present, otherwise re-translates
    from the gene location with the feature's (or the default) translation
    table.  Duplicate identifiers raise (``gecco/orf.py:188-191``).
    """

    def __init__(
        self,
        feature: str = "CDS",
        translation_table: int = 11,
        locus_tag: str = "locus_tag",
    ) -> None:
        self.feature = feature
        self.translation_table = translation_table
        self.locus_tag = locus_tag

    def find_genes(
        self,
        records: Iterable[SeqRecord],
        progress: Optional[Callable[[SeqRecord, int], None]] = None,
    ) -> Iterator[Gene]:
        ids = set()
        _progress = (lambda x, y: None) if progress is None else progress
        for record in records:
            genes_found = 0
            features = (f for f in record.features if f.type == self.feature)
            for i, feature in enumerate(features):
                table = feature.qualifiers.get("transl_table", [self.translation_table])[0]
                if "translation" in feature.qualifiers:
                    prot_seq = Seq(feature.qualifiers["translation"][0])
                else:
                    prot_seq = feature.location.extract(record.seq).translate(table=int(table))
                if self.locus_tag in feature.qualifiers:
                    protein = Protein(id=feature.qualifiers[self.locus_tag][0], seq=prot_seq)
                else:
                    protein = Protein(id=f"{record.id}_{i+1}", seq=prot_seq)
                if protein.id in ids:
                    raise ValueError(
                        f"Duplicate gene identifier found in {record.id!r}: {protein.id!r}"
                    )
                ids.add(protein.id)
                yield Gene(
                    source=record,
                    start=feature.location.start + 1,
                    end=feature.location.end,
                    strand=Strand(feature.location.strand or 1),
                    protein=protein,
                )
                genes_found += 1
            _progress(record, genes_found)


def _parse_gff3(path) -> Dict[str, List[SeqFeature]]:
    """Parse a GFF3 file into per-sequence feature lists (CDS-level)."""
    features: Dict[str, List[SeqFeature]] = {}
    with open(path) as handle:
        for line in handle:
            if line.startswith("##FASTA"):
                break
            if not line.strip() or line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 8:
                continue
            seqid, _source, ftype, start, end, _score, strand, _phase = fields[:8]
            qualifiers: Dict[str, List[str]] = {}
            if len(fields) > 8:
                for pair in fields[8].split(";"):
                    if "=" in pair:
                        key, _, value = pair.partition("=")
                        qualifiers.setdefault(key.strip(), []).append(value.strip())
            location = FeatureLocation(int(start) - 1, int(end), -1 if strand == "-" else 1)
            features.setdefault(seqid, []).append(
                SeqFeature(location=location, type=ftype, qualifiers=qualifiers)
            )
    return features


class GFFFinder(ORFFinder):
    """Extracts ``CDS`` features described in a GFF3 sidecar file."""

    def __init__(
        self,
        gff_file,
        feature: str = "CDS",
        translation_table: int = 11,
        locus_tag: str = "ID",
    ) -> None:
        self.feature = feature
        self.translation_table = translation_table
        self.locus_tag = locus_tag
        self.features = _parse_gff3(gff_file)

    def find_genes(
        self,
        records: Iterable[SeqRecord],
        progress: Optional[Callable[[SeqRecord, int], None]] = None,
    ) -> Iterator[Gene]:
        ids = set()
        _progress = (lambda x, y: None) if progress is None else progress
        for record in records:
            if record.id not in self.features:
                warnings.warn(f"no annotations found for record {record.id!r}")
                continue
            genes_found = 0
            features = (f for f in self.features[record.id] if f.type == self.feature)
            for i, feature in enumerate(features):
                table = feature.qualifiers.get("transl_table", [self.translation_table])[0]
                prot_seq = feature.location.extract(record.seq).translate(table=int(table))
                if self.locus_tag in feature.qualifiers:
                    protein = Protein(id=feature.qualifiers[self.locus_tag][0], seq=prot_seq)
                else:
                    protein = Protein(id=f"{record.id}_{i+1}", seq=prot_seq)
                if protein.id in ids:
                    raise ValueError(
                        f"Duplicate gene identifier found in {record.id!r}: {protein.id!r}"
                    )
                ids.add(protein.id)
                yield Gene(
                    source=record,
                    start=feature.location.start + 1,
                    end=feature.location.end,
                    strand=Strand(feature.location.strand or 1),
                    protein=protein,
                )
                genes_found += 1
            _progress(record, genes_found)


def __getattr__(name: str):
    # lazy import: the de-novo finder pulls in numpy machinery
    if name == "ScanFinder":
        from .scan import ScanFinder

        return ScanFinder
    raise AttributeError(name)
