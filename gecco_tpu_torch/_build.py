"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

One ``nvcc`` per source, all started together, compiles the objects;
one more links them into a shared library with a plain C interface,
loaded through :mod:`ctypes`.  The library is keyed by a hash of the
sources and flags and written under ``gecco_tpu_torch/_build/``, so a
checkout builds once and a source change rebuilds.  A failed build
raises; nothing falls back to the plain versions.

Each kernel wrapper counts its launches as the counter
``launch.<kernel>`` of :data:`gecco_tpu_torch.profiling.TIMER`, so that a
run can show that the main path went through the kernels, also when
several threads launch (a sharded search, ``SearchPipeline(devices=...)``).
The first call of :func:`library` is the span ``load-kernels``, and each
build counts one ``kernel_builds``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

from .profiling import TIMER

__all__ = ["library", "check", "resource_usage", "FLAGS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")

FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # xs, offsets, lens, loops, moves, n_seqs, e_log, tbm, prof_idx,
    # n_prof, model_len, P, Mp, width, out, stream
    "gecco_ssv_filter": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P],
    # kernel I takes the sequences' order (SeqPack.by_length) after n_seqs
    "gecco_msv_filter": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P],
    # xs, offsets, lens, loops, moves, pair_seq, pair_prof, n_pairs,
    # e, trans, model_len, P, Mp, width, blocks, n_blocks (the block
    # schedule of hmm.kernels.pair_blocks), starts, ends (both null for
    # whole sequences), out, stream
    "gecco_viterbi_pairs": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _I, _P,
                            _P, _P, _P],
    "gecco_forward_pairs": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _I, _P,
                            _P, _P, _P],
    # xs, offsets, lens, loops, moves, n_seqs, e_odds, trans, prof_idx,
    # n_prof, model_len, P, Mp, width, viterbi, tile, out, stream
    "gecco_dense_scores": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P,
                           _P],
}
# kernels D-G, J and K: xs, offsets, lens, loops, moves, seq, prof, n_rows,
# e_odds, trans, model_len, P, Mp, width, stride, then their own arguments
# and the stream
_ROWS = [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I]
_SIGNATURES.update({
    # blocks, n_blocks (hmm.kernels.pair_blocks), out_row, n_out, traj, score
    "gecco_posterior_fwd": _ROWS + [_P, _I, _P, _I, _P, _P, _P],
    # blocks, n_blocks, out_row, n_out, traj, score, post
    "gecco_posterior_bwd": _ROWS + [_P, _I, _P, _I, _P, _P, _P, _P],
    # blocks, n_blocks, out_row, n_out, plane_width, planes, logs
    "gecco_align_bwd": _ROWS + [_P, _I, _P, _I, _I, _P, _P, _P],
    # blocks, n_blocks, out_row, n_out, plane_width, planes, logs, iv, jv,
    # total, out, coords
    "gecco_align_fwd": _ROWS + [_P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    # blocks, n_blocks, out_row, n_out, n_post, traj (scratch), score, post
    "gecco_pair_posterior": _ROWS + [_P, _I, _P, _I, _I, _P, _P, _P, _P],
    # blocks, n_blocks, out_row, n_out, plane_width, iv, jv, total,
    # env_stride, planes, logs (scratch), out, coords
    "gecco_pair_align": _ROWS + [_P, _I, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P],
})

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None


def __getattr__(name: str):
    """``launches``: each kernel's ``launch.<kernel>`` counter, as a dict
    (what ``benchmark/child.py`` records of a call); read only."""
    if name == "launches":
        return {key[len("launch."):]: n for key, n in list(TIMER.counters.items())
                if key.startswith("launch.")}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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


def _run(commands):
    """Run ``nvcc`` commands side by side; raise with the output of a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in commands]
    failed = []
    for command, proc in zip(commands, procs):
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(" ".join(command) + "\n" + output)
    if failed:
        raise RuntimeError("nvcc failed building the CUDA kernels:\n" + "\n".join(failed))


def _compile(sources, target: str) -> None:
    """One object per ``.cu`` (compiled in parallel), linked into ``target``."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        objects = []
        commands = []
        for path in sources:
            if path.endswith(".cu"):
                obj = os.path.join(tmp, os.path.basename(path) + ".o")
                objects.append(obj)
                commands.append([nvcc, *FLAGS, "-c", "-o", obj, path])
        _run(commands)
        linked = os.path.join(tmp, "lib.so")
        _run([[nvcc, *FLAGS, "-shared", "-o", linked, *objects]])
        os.replace(linked, target)


def _open(target: str) -> ctypes.CDLL:
    """Load the built library and declare its entry points."""
    lib = ctypes.CDLL(target)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` on first call."""
    global _library
    with _lock:
        if _library is not None:
            return _library
        with TIMER.span("load-kernels"):
            sources = _sources()
            digest = hashlib.sha256(" ".join(FLAGS).encode())
            for path in sources:
                with open(path, "rb") as f:
                    digest.update(os.path.basename(path).encode() + b"\0" + f.read())
            os.makedirs(_BUILD, exist_ok=True)
            target = os.path.join(_BUILD, f"libgecco_kernels_{digest.hexdigest()[:16]}.so")
            if not os.path.exists(target):
                TIMER.count("kernel_builds")
                _compile(sources, target)
            _library = _open(target)
        return _library


def resource_usage(source: str) -> str:
    """What ``nvcc -Xptxas -v`` prints for ``csrc/<source>``: the registers,
    shared memory and spills of each kernel instantiation."""
    os.makedirs(_BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        done = subprocess.run(
            [_nvcc(), *FLAGS, "-Xptxas", "-v", "-c", "-o", os.path.join(tmp, "usage.o"),
             os.path.join(_CSRC, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{done.stdout}")
    return done.stdout


def check(code: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {code})")
