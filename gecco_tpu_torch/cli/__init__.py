"""Command-line interface entry point (``gecco-tpu-torch``).

Importing it closes the span ``import``, opened by the package's first
statement; every path of the CLI imports ``torch``, timed on its own as
``import-torch``.
"""

from .. import IMPORT_SPAN
from ..profiling import TIMER

with TIMER.attach(IMPORT_SPAN), TIMER.span("import-torch"):
    import torch  # noqa: F401

from .commands import main  # noqa: E402

TIMER.finish(IMPORT_SPAN)

__all__ = ["main"]
