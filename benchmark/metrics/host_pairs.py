"""The annotator and search: the counter ``host_pairs``, the pairs whose
domains the float64 host engine defined, mean a call."""

from ._tree import trees

COUNTER = "host_pairs"


def read(run):
    values = [tree["counters"][COUNTER] for _, tree in trees(run)
              if COUNTER in tree.get("counters", {})]
    return sum(values) / len(values) if values else None
