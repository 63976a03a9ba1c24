"""Refinement and typing (``refine.py``, ``types/``): the ``extract-clusters``
and ``predict-types`` spans."""

from ._spans import mean_span


def read(run):
    return mean_span(run, "extract-clusters", "predict-types")
