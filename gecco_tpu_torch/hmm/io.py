"""Readers for profile HMM files (HMMER3 ``.hmm`` text format) and the
package's packed ``.npz`` profile-bank format.

The reference consumes binary ``.h3m`` files through pyhmmer
(``gecco/hmmer/__init__.py:119-129``); our build parses
the portable HMMER3 *text* format from scratch and packs profile banks
into padded tensors for the TPU search pipeline
(``gecco_tpu_torch.hmm.pipeline``).  All probability values in the file are
negative natural logs; ``*`` denotes probability zero.
"""

import math
import re
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, Iterator, List, Optional, Tuple, Union

import numpy

from .._meta import zopen

__all__ = ["ProfileHMM", "parse_hmmer3", "AMINO_ALPHABET", "BACKGROUND_F"]

#: Canonical amino acid order of HMMER3 emission columns.
AMINO_ALPHABET = "ACDEFGHIKLMNPQRSTVWY"

#: Easel's default amino acid background frequencies
#: (``p7_AminoFrequencies``), indexed like `AMINO_ALPHABET`.
BACKGROUND_F = numpy.array([
    0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062,
    0.0695071, 0.0229198, 0.0590092, 0.0594422, 0.0963728,
    0.0237718, 0.0414386, 0.0482904, 0.0395639, 0.0540978,
    0.0683364, 0.0540687, 0.0673417, 0.0114135, 0.0304133,
], dtype=numpy.float64)

_TRANSITIONS = ("MM", "MI", "MD", "IM", "II", "DM", "DD")


@dataclass
class ProfileHMM:
    """A core profile HMM (probability space) plus calibration metadata.

    ``match``/``insert`` are ``[M+1, 20]`` emission probabilities (row 0
    unused / COMPO); ``trans`` is ``[M+1, 7]`` with columns ordered
    ``MM MI MD IM II DM DD`` — row 0 holds the begin transitions
    ``B->{M1,I0,D1}``; row ``M`` encodes exits (``M_M->E`` at ``MM``).
    """

    name: str
    accession: Optional[str]
    description: Optional[str]
    length: int
    alphabet: str
    match: "numpy.ndarray"
    insert: "numpy.ndarray"
    trans: "numpy.ndarray"
    compo: Optional["numpy.ndarray"] = None
    stats: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    cutoffs: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    map_annotation: Optional[List[int]] = None
    consensus: Optional[str] = None

    @property
    def M(self) -> int:
        return self.length


def _parse_value(token: str) -> float:
    """A ``-ln p`` field: ``*`` means probability zero."""
    if token == "*":
        return math.inf
    return float(token)


def _probabilities(tokens: List[str]) -> "numpy.ndarray":
    return numpy.exp(-numpy.array([_parse_value(t) for t in tokens], dtype=numpy.float64))


def parse_hmmer3(path: Union[str, BinaryIO]) -> Iterator[ProfileHMM]:
    """Parse all profiles from a HMMER3 ``.hmm`` (ASCII) or ``.h3m`` file.

    Pressed binary core-model files (``.h3m``, what the reference's
    ``setup.py build_data`` ships — ``setup.py:344-372``)
    are detected by their record magic and routed to the binary reader
    (:mod:`gecco_tpu_torch.hmm.h3m`).  The auxiliary ``.h3f``/``.h3p`` halves
    of a pressed database contain no parseable core model and are
    rejected with a pointer at the ``.h3m``.
    """
    with zopen(path) as handle:
        raw = handle.read()
    from .h3m import is_h3m, read_h3m

    if is_h3m(raw):
        yield from read_h3m(raw)
        return
    try:
        text = raw.decode()
    except UnicodeDecodeError:
        raise ValueError(
            "unrecognized binary HMMER file (.h3f/.h3p/.h3i are the "
            "pressed filter/profile/index parts and hold no core "
            "model): load the .h3m or the ASCII .hmm instead"
        ) from None
    lines = iter(text.splitlines())
    header: Optional[str] = None
    for line in lines:
        if line.startswith("HMMER3"):
            header = line
            break
    if header is None:
        raise ValueError("not a HMMER3 ASCII file")
    while True:
        profile = _parse_profile(lines)
        if profile is None:
            return
        yield profile


def _parse_profile(lines) -> Optional[ProfileHMM]:
    meta: Dict[str, str] = {}
    stats: Dict[str, Tuple[float, float]] = {}
    cutoffs: Dict[str, Tuple[float, float]] = {}
    # -- header block
    for line in lines:
        if line.startswith("HMM "):
            break
        if not line.strip():
            continue
        key = line[:6].strip()
        value = line[6:].strip()
        if key == "STATS":
            parts = value.split()
            if parts[0] == "LOCAL":
                stats[parts[1]] = (float(parts[2]), float(parts[3]))
        elif key in ("GA", "TC", "NC"):
            parts = value.rstrip(";").split()
            cutoffs[key] = (float(parts[0]), float(parts[1]))
        elif key:
            meta[key] = value
        if line.startswith("//"):
            return None
    else:
        return None

    next(lines)  # the m->m m->i ... header line
    M = int(meta["LENG"])
    K = len(AMINO_ALPHABET)
    match = numpy.zeros((M + 1, K))
    insert = numpy.zeros((M + 1, K))
    trans = numpy.zeros((M + 1, 7))
    compo = None
    consensus_chars: List[str] = []
    map_annotation: List[int] = []

    first = next(lines).split()
    if first[0] == "COMPO":
        compo = _probabilities(first[1 : K + 1])
        insert0 = next(lines).split()
    else:
        insert0 = first
    insert[0] = _probabilities(insert0[:K])
    trans[0] = _probabilities(next(lines).split()[:7])

    for k in range(1, M + 1):
        fields = next(lines).split()
        if int(fields[0]) != k:
            raise ValueError(f"unexpected node index {fields[0]!r}, wanted {k}")
        match[k] = _probabilities(fields[1 : K + 1])
        annotation = fields[K + 1 :]
        if annotation:
            try:
                map_annotation.append(int(annotation[0]))
            except ValueError:
                map_annotation.append(k)
            if len(annotation) > 1:
                consensus_chars.append(annotation[1])
        insert[k] = _probabilities(next(lines).split()[:K])
        trans[k] = _probabilities(next(lines).split()[:7])

    terminator = next(lines, "//")
    if not terminator.startswith("//"):
        raise ValueError(f"expected '//' terminator, got {terminator!r}")

    return ProfileHMM(
        name=meta.get("NAME", "-"),
        accession=meta.get("ACC"),
        description=meta.get("DESC"),
        length=M,
        alphabet=meta.get("ALPH", "amino"),
        match=match,
        insert=insert,
        trans=trans,
        compo=compo,
        stats=stats,
        cutoffs=cutoffs,
        map_annotation=map_annotation or None,
        consensus="".join(consensus_chars) or None,
    )


def encode_sequence(seq: str) -> "numpy.ndarray":
    """Encode a protein string to alphabet indices; unknowns → 20 (degenerate).

    Degenerate residues score as background (odds ratio 1) in the search
    engines, matching how HMMER treats them for scoring purposes.
    """
    table = numpy.full(128, 20, dtype=numpy.int8)
    for i, ch in enumerate(AMINO_ALPHABET):
        table[ord(ch)] = i
        table[ord(ch.lower())] = i
    raw = numpy.frombuffer(seq.encode("ascii", "replace"), dtype=numpy.uint8)
    return table[numpy.minimum(raw, 127)].astype(numpy.int32)
