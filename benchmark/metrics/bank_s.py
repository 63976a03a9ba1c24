"""The annotator and search: the profile bank's spans, ``read-profiles``
(the ``.h3m`` parse), ``configure-profiles`` (``configure_local``),
``build-bank`` (``ProfileBank.build``) and ``upload-bank``
(``TorchBank.from_numpy``)."""

from ._tree import mean_spans


def read(run):
    return mean_spans(run, "read-profiles", "configure-profiles", "build-bank", "upload-bank")
