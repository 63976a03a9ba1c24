"""CLI and process start: the span ``import``, from the package's first
statement to the end of ``gecco_tpu_torch.cli``'s import (``import torch``
in it as ``import-torch``)."""

from ._tree import mean_spans


def read(run):
    return mean_spans(run, "import")
