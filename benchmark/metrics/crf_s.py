"""The CRF decode (``crf/``): the ``predict-probabilities`` span."""

from ._spans import mean_span


def read(run):
    return mean_span(run, "predict-probabilities")
