"""The annotator and search: the span ``domains``, the domain definition of
the F3 candidates (kernels D-G, the envelope finder, and the float64 host
engine for the pairs the device stages do not define)."""

from ._tree import mean_spans


def read(run):
    return mean_spans(run, "domains")
