"""gecco-tpu-torch: the GECCO-TPU pipeline on PyTorch and CUDA.

A port of ``gecco_tpu`` (JAX on a TPU) to PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (``sm_90a``) where the JAX package runs
Pallas kernels.  Module names follow ``gecco_tpu`` so every counterpart
is found by path.  The package stands alone: the host-side modules
(gene calling, tables, the profile parser, the float64 reference
engine, refinement, typing) and the data files are its own copies of
the JAX package's, and nothing here imports ``gecco_tpu`` or ``jax``.

Slice ported so far (``gecco run``):

1. gene calling — ``gecco_tpu_torch.orf`` (host, C++ core);
2. profile-HMM search — ``gecco_tpu_torch.hmm.pipeline``: SSV filter
   (kernel A), Viterbi F2 gate (kernel B), Forward rescore (kernel C)
   and domain definition (kernels D–G, ``hmm/stream.py``) on the device;
   with ``max_filter=True`` (hmmsearch ``--max``), the dense all-pairs
   Forward (kernel H) in place of the filters;
3. CRF decode — ``gecco_tpu_torch.crf`` (plain torch);
4. refinement and type classification — ``gecco_tpu_torch.refine`` and
   ``gecco_tpu_torch.types`` (host).

Every entry point takes an explicit ``device``; nothing here picks a
device on its own (see :mod:`gecco_tpu_torch._device`).
"""

from .profiling import IMPORT as _IMPORT, TIMER as _TIMER

#: the span of the process's imports, closed by ``gecco_tpu_torch.cli``
IMPORT_SPAN = _TIMER.begin(_IMPORT)

__version__ = "0.1.0"

__all__ = ["__version__"]
