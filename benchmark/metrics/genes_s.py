"""Gene calling (``orf/``): the ``extract-genes`` span."""

from ._spans import mean_span


def read(run):
    return mean_span(run, "extract-genes")
