"""gecco-tpu-torch: the GECCO-TPU pipeline on PyTorch and CUDA.

A port of ``gecco_tpu`` (JAX on a TPU) to PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (``sm_90a``) where the JAX package runs
Pallas kernels.  Module names follow ``gecco_tpu`` so every counterpart
is found by path; the host-side modules (gene calling, tables, the
profile parser, the float64 reference engine, refinement, typing) are
imported from ``gecco_tpu`` rather than copied — none of them imports
``jax``.

Slice ported so far (``gecco run``):

1. gene calling — ``gecco_tpu.orf`` (host, C++ core);
2. profile-HMM search — ``gecco_tpu_torch.hmm.pipeline``: SSV filter
   (kernel A), Viterbi F2 gate (kernel B), Forward rescore (kernel C)
   and domain definition (kernels D–G, ``hmm/stream.py``) on the device;
3. CRF decode — ``gecco_tpu_torch.crf`` (plain torch);
4. refinement and type classification — ``gecco_tpu`` (host).

Every entry point takes an explicit ``device``; nothing here picks a
device on its own (see :mod:`gecco_tpu_torch._device`).
"""

from gecco_tpu import __version__

__all__ = ["__version__"]
