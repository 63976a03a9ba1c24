"""Command-line interface entry point (``gecco-tpu-torch``)."""

from .commands import main

__all__ = ["main"]
