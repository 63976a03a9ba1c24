"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles every source into one shared library with a plain C
interface, loaded through :mod:`ctypes`.  The library is keyed by a hash
of the sources and flags and written under ``gecco_tpu_torch/_build/``,
so a checkout builds once and a source change rebuilds.  A failed build
raises; nothing falls back to the plain versions.

Each kernel wrapper counts its launches in :data:`launches`, so a run
can show that the main path went through the kernels.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Optional

__all__ = ["library", "launches", "reset_launches", "check", "FLAGS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")

FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

#: launches of each kernel since the last :func:`reset_launches`
launches: Dict[str, int] = {"ssv_filter": 0, "viterbi_pairs": 0, "forward_pairs": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # xs, offsets, lens, loops, moves, n_seqs, e_log, tbm, prof_idx,
    # n_prof, model_len, P, Mp, width, out, stream
    "gecco_ssv_filter": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P],
    # xs, offsets, lens, loops, moves, pair_seq, pair_prof, n_pairs,
    # e, trans, model_len, P, Mp, width, out, stream
    "gecco_viterbi_pairs": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P],
    "gecco_forward_pairs": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P],
}

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _sources():
    return sorted(
        os.path.join(_CSRC, name) for name in os.listdir(_CSRC)
        if name.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    for candidate in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` on first call."""
    global _library
    with _lock:
        if _library is not None:
            return _library
        sources = _sources()
        digest = hashlib.sha256(" ".join(FLAGS).encode())
        for path in sources:
            with open(path, "rb") as f:
                digest.update(os.path.basename(path).encode() + b"\0" + f.read())
        os.makedirs(_BUILD, exist_ok=True)
        target = os.path.join(_BUILD, f"libgecco_kernels_{digest.hexdigest()[:16]}.so")
        if not os.path.exists(target):
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
            os.close(fd)
            command = [_nvcc(), *FLAGS, "-o", tmp,
                       *[p for p in sources if p.endswith(".cu")]]
            proc = subprocess.run(command, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    "nvcc failed building the CUDA kernels:\n"
                    + " ".join(command) + "\n" + proc.stdout + proc.stderr)
            os.replace(tmp, target)
        lib = ctypes.CDLL(target)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _library = lib
        return lib


def check(code: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {code})")
