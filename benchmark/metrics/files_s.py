"""CLI and process start: the program's files, the spans ``read-inputs``
(FASTA and tables), ``load-models`` (the type classifier) and
``write-outputs`` (tables, GenBank, sideload JSON)."""

from ._tree import mean_spans


def read(run):
    return mean_spans(run, "read-inputs", "load-models", "write-outputs")
