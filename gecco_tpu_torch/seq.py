"""Minimal biological sequence objects (no Biopython dependency).

Provides the subset of sequence functionality the pipeline needs:
nucleotide reverse-complement, translation with NCBI genetic codes,
and record/feature containers used by the GenBank/FASTA IO layer
(``gecco_tpu_torch.seqio``).

Behavioral reference for the record/feature data carried around:
``gecco/model.py:240-344`` (Bio.SeqRecord usage) —
re-designed as plain lightweight classes here.
"""

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple, Union

__all__ = [
    "Seq",
    "reverse_complement",
    "translate",
    "SeqRecord",
    "SeqFeature",
    "FeatureLocation",
    "GENETIC_CODES",
]

_COMPLEMENT = str.maketrans(
    "ACGTUMRWSYKVHDBNacgtumrwsykvhdbn",
    "TGCAAKYWSRMBDHVNtgcaakywsrmbdhvn",
)

# NCBI genetic code tables as (AAs string indexed by codon rank, starts string).
# Codon rank: 16*b1 + 4*b2 + b3 with T=0, C=1, A=2, G=3 (NCBI ordering).
# Table 1 = standard, table 4 = mold/protozoan mito, table 11 = bacterial.
_NCBI_BASES = "TCAG"
GENETIC_CODES: Dict[int, Tuple[str, str]] = {
    1: (
        "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "---M------**--*----M---------------M----------------------------",
    ),
    4: (
        "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "--MM------**-------M------------MMMM---------------M------------",
    ),
    11: (
        "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "---M------**--*----M------------MMMM---------------M------------",
    ),
}

_BASE_INDEX = {"T": 0, "U": 0, "C": 1, "A": 2, "G": 3}


def _codon_rank(codon: str) -> int:
    """Rank of a codon in NCBI table order, or -1 if ambiguous."""
    r = 0
    for ch in codon:
        idx = _BASE_INDEX.get(ch)
        if idx is None:
            return -1
        r = r * 4 + idx
    return r


def reverse_complement(seq: str) -> str:
    """Reverse-complement a nucleotide string (IUPAC-aware)."""
    return seq.translate(_COMPLEMENT)[::-1]


#: per-table vectorized lookup: codon rank (0..63, 64 = ambiguous) -> aa byte
_CODON_TABLES: Dict[int, "object"] = {}


def _codon_table(table: int):
    import numpy

    cached = _CODON_TABLES.get(table)
    if cached is None:
        aas, _ = GENETIC_CODES[table]
        cached = numpy.frombuffer(
            (aas + "X").encode("ascii"), dtype=numpy.uint8).copy()
        _CODON_TABLES[table] = cached
    return cached


_BASE_RANKS = None


def _base_ranks():
    global _BASE_RANKS
    if _BASE_RANKS is None:
        import numpy

        ranks = numpy.full(128, -1, dtype=numpy.int8)
        for ch, idx in _BASE_INDEX.items():
            ranks[ord(ch)] = idx
            ranks[ord(ch.lower())] = idx
        _BASE_RANKS = ranks
    return _BASE_RANKS


def translate(
    seq: str,
    table: int = 11,
    to_stop: bool = False,
    stop_symbol: str = "*",
) -> str:
    """Translate a nucleotide sequence to amino acids.

    Trailing partial codons are ignored.  Ambiguous codons translate to
    ``X`` unless every resolution agrees (we keep it simple: ambiguous →
    ``X``, except fully-determined stop/aa via the table).

    Vectorized (one table lookup per codon): translation is in the
    gene caller's per-genome hot path — ~1 Mbp of protein per 3 Mbp
    genome — and a per-codon Python loop costed more than the whole
    native ORF scan.
    """
    import numpy

    n = (len(seq) // 3) * 3
    if n == 0:
        return ""
    raw = numpy.frombuffer(seq[:n].encode("ascii", "replace"), dtype=numpy.uint8)
    base = _base_ranks()[numpy.minimum(raw, 127)].reshape(-1, 3).astype(numpy.int32)
    ranks = base[:, 0] * 16 + base[:, 1] * 4 + base[:, 2]
    ranks[(base < 0).any(axis=1)] = 64          # ambiguous -> 'X'
    out = _codon_table(table)[ranks]
    stops = out == ord("*")
    if to_stop:
        if stops.any():
            out = out[: int(numpy.argmax(stops))]
    elif stop_symbol != "*" and stops.any():
        out[stops] = ord(stop_symbol)
    return out.tobytes().decode("ascii")


class Seq(str):
    """A string subclass with nucleotide/protein convenience methods."""

    def reverse_complement(self) -> "Seq":
        return Seq(reverse_complement(self))

    def translate(self, table: int = 11, to_stop: bool = False) -> "Seq":
        return Seq(translate(self, table=table, to_stop=to_stop))


class UnknownSeq(Seq):
    """A lazily-materialized run of ``N`` used when only coordinates are known.

    Mirrors the role of ``gecco/model.py:598-618`` (`_UnknownSeq`): genes
    loaded from tables have no real source sequence, but code may still
    slice it.
    """

    def __new__(cls, length: int = 0):
        obj = super().__new__(cls, "")
        obj._length = length  # type: ignore[attr-defined]
        return obj

    def __getitem__(self, index):  # noqa: D105
        if isinstance(index, slice):
            start = index.start or 0
            stop = index.stop if index.stop is not None else start
            step = index.step or 1
            return Seq("N" * max(0, (stop - start) // step))
        return "N"


@dataclass
class FeatureLocation:
    """A 0-based, end-exclusive location on a sequence.

    ``parts`` carries the segments of a compound (``join(...)``)
    location in listed (file) order; ``start``/``end`` always span
    the envelope, so coordinate consumers need no special casing, while
    :meth:`extract` splices the parts (reverse order + reverse
    complement on the minus strand) like Biopython's
    ``CompoundLocation.extract`` — the reference translates multi-exon
    CDS through that path (``gecco/orf.py:149-201``).
    """

    start: int
    end: int
    strand: Optional[int] = None
    parts: Optional[List["FeatureLocation"]] = None

    def __add__(self, offset: int) -> "FeatureLocation":
        return FeatureLocation(
            self.start + offset, self.end + offset, self.strand,
            [p + offset for p in self.parts] if self.parts else None,
        )

    def __len__(self) -> int:
        if self.parts:
            return sum(len(p) for p in self.parts)
        return self.end - self.start

    def extract(self, seq: str) -> Seq:
        if self.parts:
            ordered = self.parts if self.strand != -1 else list(reversed(self.parts))
            return Seq("".join(p.extract(seq) for p in ordered))
        sub = seq[self.start : self.end]
        if self.strand == -1:
            return Seq(reverse_complement(sub))
        return Seq(sub)


@dataclass
class SeqFeature:
    """A located, typed annotation with multi-valued qualifiers."""

    location: FeatureLocation
    type: str = "misc_feature"
    qualifiers: Dict[str, List[str]] = field(default_factory=dict)


@dataclass
class SeqRecord:
    """A named sequence with annotations and features."""

    id: str
    seq: Seq = Seq("")
    name: str = ""
    description: str = ""
    annotations: Dict[str, object] = field(default_factory=dict)
    features: List[SeqFeature] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.name:
            self.name = self.id

    def __len__(self) -> int:
        return len(self.seq)

    def __getitem__(self, index: slice) -> "SeqRecord":
        """Slice the record, keeping features fully contained in the window."""
        if not isinstance(index, slice):
            raise TypeError("SeqRecord can only be sliced")
        start = index.start or 0
        stop = index.stop if index.stop is not None else len(self.seq)
        features = [
            SeqFeature(
                FeatureLocation(f.location.start - start, f.location.end - start, f.location.strand),
                f.type,
                {k: list(v) for k, v in f.qualifiers.items()},
            )
            for f in self.features
            if f.location.start >= start and f.location.end <= stop
        ]
        return SeqRecord(
            id=self.id,
            seq=Seq(self.seq[start:stop]),
            name=self.name,
            description=self.description,
            annotations=dict(self.annotations),
            features=features,
        )
