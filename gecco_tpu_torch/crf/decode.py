"""Batched linear-chain CRF posterior marginals in PyTorch.

Port of ``gecco_tpu.crf.decode.marginals_jax`` (a jitted pair of
``lax.scan`` passes): CRFsuite's scaled forward–backward in probability
space over a ``[B, W, L]`` window batch, as two loops over the window
positions, each step a batched ``[B, L] @ [L, L]`` product.  It is a
scan, not a Pallas kernel, so it stays plain torch.

Float32 products run in full float32 (``torch.backends.cuda.matmul.
allow_tf32`` is False by default; TF32 would keep only ~3 digits).
"""

import torch

__all__ = ["marginals_torch"]


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
