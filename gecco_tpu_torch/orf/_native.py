"""ctypes bindings for the native ORF-scanning core (``csrc/host/orfscan.cpp``).

The library is built on demand by ``ensure_built()`` with ``g++`` into
the package's ``_build/`` directory (keyed by a hash of the source, so a
source change rebuilds); without a C++ toolchain, callers fall back to
the pure-Python implementations in ``gecco_tpu_torch.orf.scan``
(identical semantics, tested for equality).  :func:`path` says which of
the two the gene finder runs.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy

__all__ = ["load", "ensure_built", "path", "native_candidates", "native_annotate",
           "native_hexamer_counts", "native_scores", "native_select"]

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PACKAGE, "csrc", "host", "orfscan.cpp")
_BUILD = os.path.join(_PACKAGE, "_build")
_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _lib_path() -> str:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(_BUILD, f"liborfscan_{digest.hexdigest()[:16]}.so")


def ensure_built(quiet: bool = True) -> bool:
    """Build the shared library with ``g++`` unless it is there; True on success."""
    target = _lib_path()
    if os.path.exists(target):
        return True
    os.makedirs(_BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        built = os.path.join(tmp, "liborfscan.so")
        try:
            subprocess.run(["g++", *_FLAGS, "-o", built, _SOURCE],
                           check=True, capture_output=quiet)
        except (OSError, subprocess.CalledProcessError):
            return False
        os.replace(built, target)
    return True


def path() -> str:
    """``"native"`` when the C++ core loads, else ``"python"``."""
    return "native" if load() is not None else "python"


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or `None`."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not ensure_built():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(_lib_path())
    except OSError:
        _load_failed = True
        return None
    lib.orfscan_candidates.restype = ctypes.c_int
    lib.orfscan_candidates.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.orfscan_hexamer_counts.restype = None
    lib.orfscan_hexamer_counts.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.orfscan_score.restype = None
    lib.orfscan_score.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.orfscan_annotate.restype = None
    lib.orfscan_annotate.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int8),
    ]
    lib.orfscan_select.restype = ctypes.c_int
    lib.orfscan_select.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return _lib


def _ptr(array, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def native_candidates(
    codes: "numpy.ndarray", min_gene: int, max_starts: int
) -> Optional[Tuple["numpy.ndarray", "numpy.ndarray", "numpy.ndarray"]]:
    lib = load()
    if lib is None:
        return None
    codes8 = numpy.ascontiguousarray(codes, dtype=numpy.int8)
    capacity = max(1024, len(codes8))
    while True:
        starts = numpy.empty(capacity, dtype=numpy.int32)
        ends = numpy.empty(capacity, dtype=numpy.int32)
        flags = numpy.empty(capacity, dtype=numpy.uint8)
        count = lib.orfscan_candidates(
            _ptr(codes8, ctypes.c_int8), len(codes8), min_gene, max_starts,
            _ptr(starts, ctypes.c_int32), _ptr(ends, ctypes.c_int32),
            _ptr(flags, ctypes.c_uint8), capacity,
        )
        if count >= 0:
            return starts[:count].copy(), ends[:count].copy(), flags[:count].copy()
        capacity *= 2


def native_annotate(
    codes: "numpy.ndarray", starts: "numpy.ndarray", flags: "numpy.ndarray",
) -> Optional[Tuple["numpy.ndarray", "numpy.ndarray"]]:
    """``(codon, rbs)`` int8 classes of each candidate (``scan._annotate``)."""
    lib = load()
    if lib is None:
        return None
    codes8 = numpy.ascontiguousarray(codes, dtype=numpy.int8)
    starts32 = numpy.ascontiguousarray(starts, dtype=numpy.int32)
    flags8 = numpy.ascontiguousarray(flags, dtype=numpy.uint8)
    if len(starts32) and not (0 <= starts32.min() and starts32.max() + 3 <= len(codes8)):
        raise ValueError("candidate start outside the sequence")
    codon = numpy.empty(len(starts32), dtype=numpy.int8)
    rbs = numpy.empty(len(starts32), dtype=numpy.int8)
    lib.orfscan_annotate(
        _ptr(codes8, ctypes.c_int8), len(codes8),
        _ptr(starts32, ctypes.c_int32), _ptr(flags8, ctypes.c_uint8), len(starts32),
        _ptr(codon, ctypes.c_int8), _ptr(rbs, ctypes.c_int8),
    )
    return codon, rbs


def native_select(
    starts: "numpy.ndarray", ends: "numpy.ndarray", scores: "numpy.ndarray",
    floor: float, max_overlap: int,
) -> Optional["numpy.ndarray"]:
    """Indices of the DP's selected candidates, in order of end (``scan._select``)."""
    lib = load()
    if lib is None:
        return None
    starts32 = numpy.ascontiguousarray(starts, dtype=numpy.int32)
    ends32 = numpy.ascontiguousarray(ends, dtype=numpy.int32)
    values = numpy.ascontiguousarray(scores, dtype=numpy.float64)
    if not len(starts32) == len(ends32) == len(values):
        raise ValueError("starts, ends and scores differ in length")
    out = numpy.empty(len(starts32), dtype=numpy.int32)
    count = lib.orfscan_select(
        _ptr(starts32, ctypes.c_int32), _ptr(ends32, ctypes.c_int32),
        _ptr(values, ctypes.c_double), len(values), float(floor), int(max_overlap),
        _ptr(out, ctypes.c_int32),
    )
    return out[:count].astype(numpy.intp)


def native_hexamer_counts(codes: "numpy.ndarray", spans) -> Optional["numpy.ndarray"]:
    """In-frame hexamer counts (plus one) over ``[k, 2]`` spans ``(begin, end)``."""
    lib = load()
    if lib is None:
        return None
    codes8 = numpy.ascontiguousarray(codes, dtype=numpy.int8)
    counts = numpy.ones(4096, dtype=numpy.float64)
    if len(spans):
        span_arr = numpy.asarray(spans, dtype=numpy.int32).reshape(-1, 2)
        begins = numpy.ascontiguousarray(span_arr[:, 0])
        ends = numpy.ascontiguousarray(span_arr[:, 1])
        lib.orfscan_hexamer_counts(
            _ptr(codes8, ctypes.c_int8), len(codes8),
            _ptr(begins, ctypes.c_int32), _ptr(ends, ctypes.c_int32), len(begins),
            _ptr(counts, ctypes.c_double),
        )
    return counts


def native_scores(
    codes: "numpy.ndarray", log_odds: "numpy.ndarray",
    starts: "numpy.ndarray", ends: "numpy.ndarray",
) -> Optional["numpy.ndarray"]:
    lib = load()
    if lib is None:
        return None
    codes8 = numpy.ascontiguousarray(codes, dtype=numpy.int8)
    odds = numpy.ascontiguousarray(log_odds, dtype=numpy.float64)
    starts32 = numpy.ascontiguousarray(starts, dtype=numpy.int32)
    ends32 = numpy.ascontiguousarray(ends, dtype=numpy.int32)
    out = numpy.empty(len(starts32), dtype=numpy.float64)
    lib.orfscan_score(
        _ptr(codes8, ctypes.c_int8), len(codes8), _ptr(odds, ctypes.c_double),
        _ptr(starts32, ctypes.c_int32), _ptr(ends32, ctypes.c_int32), len(starts32),
        _ptr(out, ctypes.c_double),
    )
    return out
