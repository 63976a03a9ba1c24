"""Explicit device resolution.

There is no ``auto`` device: a caller names ``"cuda"`` (or
``"cuda:N"``) or ``"cpu"``, and asking for a card where there is none
raises instead of quietly running on the host.  The search engine
(``backend``) may be ``"auto"``: the CUDA kernels on a card, the plain
PyTorch versions on the CPU, as the JAX package picks its Pallas
kernels on a TPU and its XLA engines elsewhere.
"""

import contextlib
from typing import Union

import torch

__all__ = ["BACKENDS", "resolve_device", "resolve_backend", "on_device"]

#: the search engines a caller may name
BACKENDS = ("auto", "cuda", "torch")


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """Return ``device`` as a :class:`torch.device` with an index, checking it exists."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the host"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        elif device.index >= torch.cuda.device_count():
            raise RuntimeError(f"no such CUDA device: {device}")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device: {device}")
    return device


def resolve_backend(backend: str, device: torch.device) -> str:
    """``"cuda"`` or ``"torch"``: ``backend``, or for ``"auto"`` the kernels
    on a CUDA ``device`` and the plain versions on the CPU."""
    if backend not in BACKENDS:
        raise ValueError(f"invalid backend: {backend!r}")
    if backend != "auto":
        return backend
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` for a card (the current device of a
    thread that launches there); nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
