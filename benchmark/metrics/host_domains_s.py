"""The annotator and search: the spans ``host-engine`` under ``domains``, the
float64 host engine's domain definition of the pairs that the device stages
refuse or whose envelope slots overflow.  A call whose tree counts those
routes (the counter ``host_pairs.length``) reads 0 where it holds no such
span; a program that counts no routes gives no reading."""

from ._tree import span_seconds, trees

SPAN = "host-engine"
ROUTES = "host_pairs.length"


def read(run):
    values = [span_seconds(tree, {SPAN}) for _, tree in trees(run)
              if ROUTES in tree.get("counters", {})]
    return sum(values) / len(values) if values else None
