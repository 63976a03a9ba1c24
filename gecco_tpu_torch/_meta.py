"""Small host-side utilities shared across the package.

Behavioral reference: ``gecco/_meta.py`` (sliding_window
:124-132, zopen :168-186, UniversalContainer :113-121, patch_locale
:135-144).  Implementation is independent.
"""

import bz2
import contextlib
import gzip
import io
import locale
import lzma
import os
from typing import BinaryIO, Iterator, Union

__all__ = ["sliding_window", "zopen", "UniversalContainer", "patch_locale"]

_GZIP_MAGIC = b"\x1f\x8b"
_BZ2_MAGIC = b"BZh"
_XZ_MAGIC = b"\xfd7zXZ"
_LZ4_MAGIC = b"\x04\x22\x4d\x18"

try:  # optional, not in the base image
    import lz4.frame as _lz4frame  # type: ignore
except ImportError:  # pragma: no cover
    _lz4frame = None


class UniversalContainer(object):
    """A container that reports containing every item."""

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"

    def __contains__(self, item: object) -> bool:
        return True


def sliding_window(length: int, window: int, step: int) -> Iterator[slice]:
    """Iterate slices of size ``window`` advancing by ``step``.

    Only yields full windows; a sequence shorter than ``window`` yields
    nothing (callers pad first, see ``crf.ClusterCRF``).
    """
    if window <= 0:
        raise ValueError("Window size must be strictly positive")
    if step <= 0 or step > window:
        raise ValueError("Window step must be strictly positive and under `window_size`")
    for i in range(0, length + 1 - window, step):
        yield slice(i, i + window)


@contextlib.contextmanager
def patch_locale(name: str) -> Iterator[None]:
    """Temporarily switch ``LC_TIME`` (used when formatting GenBank dates)."""
    previous = locale.setlocale(locale.LC_TIME)
    try:
        locale.setlocale(locale.LC_TIME, name)
        yield
    finally:
        locale.setlocale(locale.LC_TIME, previous)


@contextlib.contextmanager
def zopen(path: Union[str, "os.PathLike[str]", BinaryIO]) -> Iterator[BinaryIO]:
    """Open a file transparently decompressing gzip/bz2/xz/lz4 by magic bytes."""
    with contextlib.ExitStack() as ctx:
        if hasattr(path, "read"):
            file: BinaryIO = io.BufferedReader(path)  # type: ignore[arg-type]
        else:
            file = ctx.enter_context(open(os.fspath(path), "rb"))  # type: ignore[arg-type]
            file = io.BufferedReader(file)  # type: ignore[arg-type]
        peek = file.peek(8)
        if peek.startswith(_GZIP_MAGIC):
            file = ctx.enter_context(gzip.open(file, mode="rb"))  # type: ignore[assignment]
        elif peek.startswith(_BZ2_MAGIC):
            file = ctx.enter_context(bz2.open(file, mode="rb"))  # type: ignore[assignment]
        elif peek.startswith(_XZ_MAGIC):
            file = ctx.enter_context(lzma.open(file, mode="rb"))  # type: ignore[assignment]
        elif peek.startswith(_LZ4_MAGIC):
            if _lz4frame is None:
                raise RuntimeError("File compression is LZ4 but python-lz4 is not installed")
            file = ctx.enter_context(_lz4frame.open(file))  # type: ignore[assignment]
        yield file
