"""Batched linear-chain CRF posterior marginals.

Port of ``gecco_tpu.crf.decode``:

* :func:`marginals_numpy` — a copy of the float64 host path, which
  mirrors CRFsuite's ``crf1d_context`` scaling order;
* :func:`marginals_torch` — port of ``marginals_jax`` (a jitted pair of
  ``lax.scan`` passes): CRFsuite's scaled forward–backward in
  probability space over a ``[B, W, L]`` window batch, as two loops over
  the window positions, each step a batched ``[B, L] @ [L, L]`` product.
  It is a scan, not a Pallas kernel, so it stays plain torch.

Float32 products run in full float32 (``torch.backends.cuda.matmul.
allow_tf32`` is False by default; TF32 would keep only ~3 digits).
"""

import numpy
import torch

__all__ = ["marginals_numpy", "marginals_torch"]


def marginals_numpy(emissions: "numpy.ndarray", trans: "numpy.ndarray") -> "numpy.ndarray":
    """Forward–backward marginals for a batch of windows (float64, host).

    Arguments:
        emissions: ``[B, W, L]`` per-position state scores (log-space,
            i.e. sums of state-feature weights).
        trans: ``[L, L]`` transition weights (log-space).

    Returns:
        ``[B, W, L]`` posterior marginals.
    """
    emissions = numpy.asarray(emissions, dtype=numpy.float64)
    B, W, L = emissions.shape
    exp_state = numpy.exp(emissions)
    exp_trans = numpy.exp(numpy.asarray(trans, dtype=numpy.float64))

    alpha = numpy.empty((B, W, L))
    scale = numpy.empty((B, W))
    a = exp_state[:, 0, :].copy()
    s = a.sum(axis=1)
    scale[:, 0] = 1.0 / s
    a *= scale[:, 0, None]
    alpha[:, 0] = a
    for t in range(1, W):
        a = (a @ exp_trans) * exp_state[:, t, :]
        s = a.sum(axis=1)
        scale[:, t] = 1.0 / s
        a *= scale[:, t, None]
        alpha[:, t] = a

    beta = numpy.empty((B, W, L))
    b = numpy.broadcast_to(scale[:, W - 1, None], (B, L)).copy()
    beta[:, W - 1] = b
    for t in range(W - 2, -1, -1):
        b = (exp_state[:, t + 1, :] * b) @ exp_trans.T
        b *= scale[:, t, None]
        beta[:, t] = b

    marginals = alpha * beta / scale[:, :, None]
    return marginals



def marginals_torch(emissions, trans, *, device, dtype=torch.float32) -> torch.Tensor:
    """Forward–backward marginals of a window batch, ``[B, W, L]``.

    Arguments:
        emissions: ``[B, W, L]`` per-position state scores (log space).
        trans: ``[L, L]`` transition weights (log space).
        device: where to decode.
    """
    exp_state = torch.exp(torch.as_tensor(emissions, dtype=dtype, device=device))
    exp_trans = torch.exp(torch.as_tensor(trans, dtype=dtype, device=device))
    B, W, L = exp_state.shape
    alpha = torch.empty((B, W, L), dtype=dtype, device=device)
    scale = torch.empty((B, W), dtype=dtype, device=device)
    a = exp_state[:, 0, :]
    s = 1.0 / a.sum(dim=-1, keepdim=True)
    a = a * s
    alpha[:, 0], scale[:, 0] = a, s[:, 0]
    for t in range(1, W):
        a = (a @ exp_trans) * exp_state[:, t, :]
        s = 1.0 / a.sum(dim=-1, keepdim=True)
        a = a * s
        alpha[:, t], scale[:, t] = a, s[:, 0]
    beta = torch.empty_like(alpha)
    b = scale[:, W - 1, None].expand(B, L)
    beta[:, W - 1] = b
    for t in range(W - 2, -1, -1):
        b = ((exp_state[:, t + 1, :] * b) @ exp_trans.T) * scale[:, t, None]
        beta[:, t] = b
    return alpha * beta / scale[:, :, None]
