"""The annotator and the search (``hmm/``): the ``annotate-domains`` span."""

from ._spans import mean_span


def read(run):
    return mean_span(run, "annotate-domains")
