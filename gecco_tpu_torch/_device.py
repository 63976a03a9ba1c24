"""Explicit device resolution.

There is no ``auto`` device: a caller names ``"cuda"`` (or
``"cuda:N"``) or ``"cpu"``, and asking for a card where there is none
raises instead of quietly running on the host.
"""

from typing import Union

import torch

__all__ = ["resolve_device"]


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
