"""Embedded InterPro metadata: Pfam accession → entry, GO terms, GO families.

Behavioral reference: ``gecco/interpro/__init__.py:20-83``.
The reference ships an ``interpro.json`` resource (a git-LFS blob missing
from the mounted checkout); this loader reads the same JSON layout from
``gecco_tpu_torch/data/interpro.json`` when present and degrades to an empty
database otherwise, so annotation still works (without GO metadata).

.. note:: The *shipped* ``gecco_tpu_torch/data/interpro.json`` is a 24-entry
   fixture covering the test corpus only — NOT the full Pfam→InterPro/GO
   mapping.  Annotating other profile libraries will produce domains
   without InterPro/GO metadata (a one-shot :class:`UserWarning` says
   so at runtime).  Rebuild the full asset from the InterPro XML release
   with ``tools/update_interpro.py`` when network access is available.
"""

import gzip
import json
import os
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional

__all__ = ["GOTerm", "InterProEntry", "InterPro"]

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@dataclass
class GOTerm:
    """A single Gene Ontology term."""

    accession: str
    name: str
    namespace: str

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, type(self)):
            return NotImplemented
        return (
            self.accession == other.accession
            and self.name == other.name
            and self.namespace == other.namespace
        )

    def __hash__(self) -> int:
        return hash((type(self), self.accession, self.name, self.namespace))


@dataclass
class InterProEntry:
    """A single InterPro entry with its member signatures and GO metadata."""

    accession: str
    members: List[str]
    name: str
    databases: List[str]
    type: str
    go_terms: List[GOTerm]
    go_functions: List[GOTerm]


class InterPro:
    """A queryable subset of the InterPro database."""

    _warned_missing = False     # one-shot per process, not per instance

    def __init__(self, entries: List[InterProEntry]) -> None:
        self.entries = entries
        self.by_accession: Dict[str, InterProEntry] = {
            member: entry for entry in entries for member in entry.members
        }

    def lookup(self, accession: Optional[str]) -> Optional[InterProEntry]:
        """``by_accession.get`` with a one-shot coverage warning.

        The shipped metadata is a fixture covering the test corpus; a
        miss on a real accession most likely means the full asset was
        never rebuilt (``tools/update_interpro.py``), which silently
        drops InterPro/GO qualifiers — worth exactly one warning.
        """
        entry = self.by_accession.get(accession) if accession else None
        if entry is None and accession and not InterPro._warned_missing:
            InterPro._warned_missing = True
            warnings.warn(
                f"no InterPro entry for {accession!r}: the embedded "
                "interpro.json covers the test corpus only; rebuild the "
                "full Pfam mapping with tools/update_interpro.py "
                "(domains without an entry carry no InterPro/GO metadata)",
                UserWarning,
                stacklevel=2,
            )
        return entry

    @classmethod
    def load(cls, path: Optional[str] = None) -> "InterPro":
        """Load the embedded metadata, or an empty database if absent."""
        if path is None:
            for candidate in ("interpro.json", "interpro.json.gz"):
                candidate_path = os.path.join(_DATA_DIR, candidate)
                if os.path.exists(candidate_path):
                    path = candidate_path
                    break
        if path is None or not os.path.exists(path):
            return cls([])
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:  # type: ignore[operator]
            data = json.load(f)
        entries = []
        for raw in data:
            go_terms = [GOTerm(**t) for t in raw.pop("go_terms")]
            go_functions = [
                GOTerm(**t, namespace="molecular_function")
                for t in raw.pop("go_functions")
            ]
            entries.append(InterProEntry(**raw, go_terms=go_terms, go_functions=go_functions))
        return cls(entries)
