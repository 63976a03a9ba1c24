"""Sequence file IO: FASTA / GenBank / EMBL parsing and GenBank writing.

The reference delegates to Biopython (``gecco/cli/commands/_common.py:133-166``
for reading, ``Bio.SeqIO.write`` for cluster GenBank output); this module
implements the needed subset from scratch on ``gecco_tpu_torch.seq`` objects.
The GenBank writer replicates the column layout Biopython produces so that
cluster records match the reference goldens
(``tests/test_cli/data/BGC0001866.1_cluster_1.gbk``) line-for-line modulo
run metadata (date/version).
"""

import io
import re
import textwrap
from typing import BinaryIO, Dict, Iterator, List, Optional, Tuple, Union

from ._meta import zopen
from .seq import FeatureLocation, Seq, SeqFeature, SeqRecord

__all__ = [
    "guess_sequences_format",
    "parse",
    "parse_fasta",
    "parse_genbank",
    "parse_embl",
    "write_fasta",
    "write_genbank",
]


# ---------------------------------------------------------------------------
# format sniffing (reference: gecco/cli/_utils.py:47-69)
# ---------------------------------------------------------------------------

def guess_sequences_format(path: Union[str, "BinaryIO"]) -> Optional[str]:
    """Guess the format of a sequence file by peeking at its first bytes."""
    with zopen(path) as file:
        head = file.read(256).lstrip()
    if head.startswith(b">"):
        return "fasta"
    if head.startswith(b"LOCUS"):
        return "genbank"
    if head.startswith(b"ID"):
        return "embl"
    return None


def parse(path: Union[str, "BinaryIO"], format: Optional[str] = None) -> Iterator[SeqRecord]:
    """Parse records from a (possibly compressed) sequence file."""
    if format is None:
        format = guess_sequences_format(path)
    if format == "fasta":
        return parse_fasta(path)
    if format == "genbank":
        return parse_genbank(path)
    if format == "embl":
        return parse_embl(path)
    raise ValueError(f"could not determine sequence format: {format!r}")


# ---------------------------------------------------------------------------
# FASTA
# ---------------------------------------------------------------------------

def parse_fasta(path: Union[str, "BinaryIO"]) -> Iterator[SeqRecord]:
    with zopen(path) as file:
        text = file.read().decode()
    header: Optional[str] = None
    chunks: List[str] = []
    for line in text.splitlines():
        if line.startswith(">"):
            if header is not None:
                yield _fasta_record(header, chunks)
            header = line[1:].strip()
            chunks = []
        elif line.strip():
            chunks.append(line.strip())
    if header is not None:
        yield _fasta_record(header, chunks)


def _fasta_record(header: str, chunks: List[str]) -> SeqRecord:
    parts = header.split(None, 1)
    record_id = parts[0] if parts else ""
    description = header
    return SeqRecord(id=record_id, seq=Seq("".join(chunks)), description=description)


def write_fasta(records, handle, width: int = 60) -> None:
    """Write records in FASTA format (60-column wrap like Biopython)."""
    own = isinstance(handle, (str, bytes))
    fh = open(handle, "w") if own else handle
    try:
        for record in records:
            description = record.description or record.id
            if description.split(None, 1)[0:1] == [record.id]:
                header = description
            else:
                header = f"{record.id} {description}".strip()
            fh.write(f">{header}\n")
            seq = str(record.seq)
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width])
                fh.write("\n")
    finally:
        if own:
            fh.close()


# ---------------------------------------------------------------------------
# GenBank parsing
# ---------------------------------------------------------------------------

_LOCATION_RE = re.compile(r"([<>]?)(\d+)\.\.([<>]?)(\d+)")


def _split_top_level(text: str) -> List[str]:
    """Split a location string on commas outside parentheses."""
    parts: List[str] = []
    depth = 0
    current: List[str] = []
    for ch in text:
        if ch == "," and depth == 0:
            parts.append("".join(current))
            current = []
            continue
        depth += (ch == "(") - (ch == ")")
        current.append(ch)
    parts.append("".join(current))
    return parts


def _flip(location: FeatureLocation) -> FeatureLocation:
    strand = -(location.strand or 1)
    return FeatureLocation(
        location.start, location.end, strand,
        [_flip(p) for p in location.parts] if location.parts else None,
    )


def _parse_location(text: str) -> Optional[FeatureLocation]:
    """Parse a GenBank location string into a FeatureLocation.

    ``join(...)``/``order(...)`` become compound locations whose
    ``start``/``end`` span the envelope and whose ``parts`` (in listed
    file order) splice correctly in ``extract`` — matching Biopython,
    which the reference uses for multi-exon CDS translation
    (``gecco/orf.py:149-201``).  ``complement`` flips the strand of the
    location and all its parts.
    """
    text = text.replace(" ", "")
    if text.startswith("complement(") and text.endswith(")"):
        inner = _parse_location(text[len("complement(") : -1])
        return None if inner is None else _flip(inner)
    if text.startswith(("join(", "order(")) and text.endswith(")"):
        segments = _split_top_level(text[text.index("(") + 1 : -1])
        parts = [_parse_location(s) for s in segments]
        if any(p is None for p in parts):
            return None
        if len(parts) == 1:
            return parts[0]
        # parts stay in LISTED order: Biopython splices join() segments
        # as written, and origin-spanning joins on circular records
        # (e.g. join(800..900,1..100)) would re-translate wrongly if
        # re-sorted by start.  Only the start/end ENVELOPE is computed
        # from the extrema.
        strands = {p.strand for p in parts}  # type: ignore[union-attr]
        strand = strands.pop() if len(strands) == 1 else 1
        return FeatureLocation(
            min(p.start for p in parts),  # type: ignore[union-attr]
            max(p.end for p in parts),  # type: ignore[union-attr]
            strand, parts,
        )
    match = _LOCATION_RE.search(text)
    if match is None:
        single = re.match(r"^[<>]?(\d+)$", text)
        if single:
            pos = int(single.group(1))
            return FeatureLocation(pos - 1, pos, 1)
        return None
    return FeatureLocation(int(match.group(2)) - 1, int(match.group(4)), 1)


def parse_genbank(path: Union[str, "BinaryIO"]) -> Iterator[SeqRecord]:
    with zopen(path) as file:
        text = file.read().decode()
    for chunk in _split_records(text, "//"):
        record = _parse_genbank_record(chunk)
        if record is not None:
            yield record


def _split_records(text: str, terminator: str) -> Iterator[List[str]]:
    lines: List[str] = []
    for line in text.splitlines():
        if line.rstrip() == terminator:
            if lines:
                yield lines
            lines = []
        else:
            lines.append(line)
    if any(l.strip() for l in lines):
        yield lines


def _parse_genbank_record(lines: List[str]) -> Optional[SeqRecord]:
    record = SeqRecord(id="", seq=Seq(""))
    i = 0
    n = len(lines)
    # -- header keywords
    while i < n and not lines[i].startswith(("FEATURES", "ORIGIN")):
        line = lines[i]
        keyword = line[:12].strip()
        value = line[12:].strip()
        if keyword == "LOCUS":
            parts = value.split()
            if parts:
                record.id = record.name = parts[0]
            if "circular" in parts:
                record.annotations["topology"] = "circular"
            elif "linear" in parts:
                record.annotations["topology"] = "linear"
            for molecule in ("DNA", "RNA", "mRNA", "ss-DNA", "ds-DNA"):
                if molecule in parts:
                    record.annotations["molecule_type"] = molecule
        elif keyword == "DEFINITION":
            parts_list = [value]
            while i + 1 < n and lines[i + 1].startswith(" " * 12):
                i += 1
                parts_list.append(lines[i].strip())
            record.description = " ".join(parts_list)
            record.annotations["definition"] = record.description
        elif keyword == "ACCESSION" and value:
            record.annotations["accession"] = value.split()[0]
        elif keyword == "VERSION" and value:
            record.annotations["version"] = value.split()[0]
            record.id = record.annotations["version"]  # type: ignore[assignment]
        elif keyword == "ORGANISM":
            record.annotations["organism"] = value
        elif keyword == "COMMENT":
            comment_lines = [value]
            while i + 1 < n and lines[i + 1].startswith(" " * 12):
                i += 1
                comment_lines.append(lines[i][12:].rstrip())
            _parse_comment(record, comment_lines)
        i += 1
    # -- features
    if i < n and lines[i].startswith("FEATURES"):
        i += 1
        current: Optional[Tuple[str, List[str]]] = None
        features_raw: List[Tuple[str, List[str]]] = []
        while i < n and not lines[i].startswith("ORIGIN"):
            line = lines[i]
            if len(line) > 5 and line[:5] == "     " and line[5] != " ":
                key = line[5:21].strip()
                current = (key, [line[21:].strip()])
                features_raw.append(current)
            elif current is not None and line.startswith(" " * 10):
                current[1].append(line[21:].strip() if len(line) > 21 else line.strip())
            i += 1
        for key, body in features_raw:
            feature = _build_feature(key, body)
            if feature is not None:
                record.features.append(feature)
    # -- sequence
    if i < n and lines[i].startswith("ORIGIN"):
        i += 1
        chunks: List[str] = []
        while i < n:
            chunks.append(re.sub(r"[\d\s]", "", lines[i]))
            i += 1
        record.seq = Seq("".join(chunks).upper())
    if not record.id:
        return None
    return record


def _parse_comment(record: SeqRecord, lines: List[str]) -> None:
    """Parse a COMMENT block, extracting ``##Name-START##`` structured parts."""
    plain: List[str] = []
    structured = None
    block_name = None
    for line in lines:
        match = re.match(r"^##(.+)-START##$", line.strip())
        if match:
            block_name = match.group(1)
            structured = record.annotations.setdefault("structured_comment", {})
            structured[block_name] = {}
            continue
        if block_name is not None:
            if re.match(rf"^##{re.escape(block_name)}-END##$", line.strip()):
                block_name = None
                continue
            key, sep, value = line.partition("::")
            if sep:
                structured[block_name][key.strip()] = value.strip()
            continue
        plain.append(line)
    if plain:
        record.annotations["comment"] = "\n".join(plain).strip()


def _build_feature(key: str, body: List[str]) -> Optional[SeqFeature]:
    # first lines (until a /qualifier) form the location
    location_parts: List[str] = []
    qualifier_lines: List[str] = []
    in_qualifiers = False
    for part in body:
        if part.startswith("/"):
            in_qualifiers = True
        if in_qualifiers:
            qualifier_lines.append(part)
        else:
            location_parts.append(part)
    location = _parse_location("".join(location_parts))
    if location is None:
        return None
    qualifiers: Dict[str, List[str]] = {}
    current_name: Optional[str] = None
    current_value: List[str] = []
    quoted = False

    def flush() -> None:
        nonlocal current_name, current_value
        if current_name is not None:
            value = " ".join(current_value).strip()
            if value.startswith('"') and value.endswith('"'):
                value = value[1:-1]
            if current_name == "translation":
                value = value.replace(" ", "")
            qualifiers.setdefault(current_name, []).append(value)
        current_name, current_value = None, []

    for part in qualifier_lines:
        if part.startswith("/") and not quoted:
            flush()
            if "=" in part:
                name, _, value = part[1:].partition("=")
                current_name = name
                current_value = [value]
                quoted = value.startswith('"') and not (len(value) > 1 and value.endswith('"'))
            else:
                qualifiers.setdefault(part[1:], []).append("")
        elif current_name is not None:
            current_value.append(part)
            if quoted and part.endswith('"'):
                quoted = False
    flush()
    return SeqFeature(location=location, type=key, qualifiers=qualifiers)


# ---------------------------------------------------------------------------
# EMBL parsing (minimal: ID/DE/FT/SQ)
# ---------------------------------------------------------------------------

def parse_embl(path: Union[str, "BinaryIO"]) -> Iterator[SeqRecord]:
    with zopen(path) as file:
        text = file.read().decode()
    for chunk in _split_records(text, "//"):
        record = _parse_embl_record(chunk)
        if record is not None:
            yield record


def _parse_embl_record(lines: List[str]) -> Optional[SeqRecord]:
    record = SeqRecord(id="", seq=Seq(""))
    features_raw: List[Tuple[str, List[str]]] = []
    current: Optional[Tuple[str, List[str]]] = None
    seq_chunks: List[str] = []
    in_seq = False
    for line in lines:
        code = line[:2]
        if code == "ID":
            record.id = record.name = line[5:].split(";")[0].strip()
        elif code == "DE":
            record.description = (record.description + " " + line[5:].strip()).strip()
        elif code == "FT":
            key = line[5:21].strip()
            rest = line[21:].strip() if len(line) > 21 else ""
            if key:
                current = (key, [rest])
                features_raw.append(current)
            elif current is not None:
                current[1].append(rest)
        elif code == "SQ":
            in_seq = True
        elif in_seq:
            seq_chunks.append(re.sub(r"[\d\s/]", "", line))
    for key, body in features_raw:
        feature = _build_feature(key, body)
        if feature is not None:
            record.features.append(feature)
    record.seq = Seq("".join(seq_chunks).upper())
    return record if record.id else None


# ---------------------------------------------------------------------------
# GenBank writing (Biopython-compatible layout)
# ---------------------------------------------------------------------------

_QUALIFIER_INDENT = " " * 21
_HEADER_WIDTH = 80
# qualifiers written without quotes, as Biopython does
_UNQUOTED_QUALIFIERS = {
    "anticodon", "citation", "codon_start", "compare", "direction",
    "estimated_length", "mod_base", "number", "rpt_type", "rpt_unit_range",
    "tag_peptide", "transl_except", "transl_table",
}


def _wrap_header(keyword: str, value: str, indent: int = 12) -> List[str]:
    prefix = keyword.ljust(indent)
    if not value:
        return [prefix.rstrip()]
    wrapped = textwrap.wrap(
        value, width=_HEADER_WIDTH - indent,
        break_long_words=True, break_on_hyphens=False,
    ) or [""]
    lines = [prefix + wrapped[0]]
    lines.extend(" " * indent + part for part in wrapped[1:])
    return lines


def _format_location(location: FeatureLocation) -> str:
    text = f"{location.start + 1}..{location.end}"
    if location.strand == -1:
        text = f"complement({text})"
    return text


def _format_qualifier(name: str, value: str) -> List[str]:
    if name in _UNQUOTED_QUALIFIERS or (value and not re.search(r"[^0-9]", value) and name == "transl_table"):
        text = f"/{name}={value}" if value else f"/{name}"
    elif value == "":
        text = f"/{name}"
    else:
        text = f'/{name}="{value}"'
    if name == "translation":
        # hard wrap, no space breaking
        width = _HEADER_WIDTH - len(_QUALIFIER_INDENT)
        return [text[i : i + width] for i in range(0, len(text), width)]
    wrapped = textwrap.wrap(
        text, width=_HEADER_WIDTH - len(_QUALIFIER_INDENT),
        break_long_words=True, break_on_hyphens=False,
    )
    return wrapped or [text]


def write_genbank(records, handle) -> None:
    """Write records in GenBank flat-file format."""
    own = isinstance(handle, (str, bytes))
    fh = open(handle, "w") if own else handle
    try:
        for record in records:
            _write_genbank_record(record, fh)
    finally:
        if own:
            fh.close()


def _write_genbank_record(record: SeqRecord, fh) -> None:
    annotations = record.annotations
    length = len(record.seq)
    name = record.name or record.id
    mol_type = str(annotations.get("molecule_type", "DNA"))
    topology = str(annotations.get("topology", "linear"))
    division = str(annotations.get("data_file_division", "UNK"))
    date = str(annotations.get("date", "01-JAN-1980"))
    length_text = str(length)
    if len(name) + len(length_text) > 28:
        name_length = f"{name} {length_text}"
    else:
        name_length = name.ljust(28 - len(length_text)) + length_text
    fh.write(
        f"LOCUS       {name_length} bp    {mol_type.ljust(7)} "
        f"{topology.ljust(8)} {division} {date}\n"
    )
    description = record.description or "."
    for line in _wrap_header("DEFINITION", description if description.endswith(".") else description + "."):
        fh.write(line + "\n")
    fh.write("ACCESSION   " + str(annotations.get("accession", record.id)) + "\n")
    fh.write("VERSION     " + str(annotations.get("version", record.id)) + "\n")
    fh.write("KEYWORDS    " + str(annotations.get("keywords", ".")) + "\n")
    fh.write("SOURCE      " + str(annotations.get("source", ".")) + "\n")
    fh.write("  ORGANISM  " + str(annotations.get("organism", ".")) + "\n")
    taxonomy = annotations.get("taxonomy")
    taxonomy_text = "; ".join(map(str, taxonomy)) + "." if taxonomy else "."
    for part in textwrap.wrap(taxonomy_text, width=_HEADER_WIDTH - 12) or ["."]:
        fh.write(" " * 12 + part + "\n")
    for i, reference in enumerate(annotations.get("references", []), start=1):  # type: ignore[arg-type]
        fh.write(f"REFERENCE   {i}\n")
        if reference.get("authors"):
            for line in _wrap_header("  AUTHORS", reference["authors"]):
                fh.write(line + "\n")
        if reference.get("title"):
            for line in _wrap_header("  TITLE", reference["title"]):
                fh.write(line + "\n")
        if reference.get("journal"):
            for line in _wrap_header("  JOURNAL", reference["journal"]):
                fh.write(line + "\n")
        if reference.get("comment"):
            for line in _wrap_header("  REMARK", reference["comment"]):
                fh.write(line + "\n")
    structured = annotations.get("structured_comment")
    if structured:
        comment_lines: List[str] = []
        for block_name, block in structured.items():  # type: ignore[union-attr]
            comment_lines.append(f"##{block_name}-START##")
            pad = max((len(k) for k in block), default=0) + 1
            for key, value in block.items():
                comment_lines.append(f"{key.ljust(pad)}:: {value}")
            comment_lines.append(f"##{block_name}-END##")
        fh.write("COMMENT     " + comment_lines[0] + "\n")
        for line in comment_lines[1:]:
            fh.write(" " * 12 + line + "\n")
    fh.write("FEATURES             Location/Qualifiers\n")
    for feature in record.features:
        location_text = _format_location(feature.location)
        fh.write("     " + feature.type.ljust(16) + location_text + "\n")
        for qualifier_name, values in feature.qualifiers.items():
            for value in values:
                for line in _format_qualifier(qualifier_name, str(value)):
                    fh.write(_QUALIFIER_INDENT + line + "\n")
    fh.write("ORIGIN\n")
    seq = str(record.seq).lower()
    for offset in range(0, len(seq), 60):
        chunk = seq[offset : offset + 60]
        groups = " ".join(chunk[i : i + 10] for i in range(0, len(chunk), 10))
        fh.write(str(offset + 1).rjust(9) + " " + groups + "\n")
    fh.write("//\n")
