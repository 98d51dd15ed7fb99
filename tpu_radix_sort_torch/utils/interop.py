"""Carrying state between the JAX package's numpy arrays and the port.

The sort has no weights: its state is its input buffers. These functions map
numpy arrays (what the JAX package takes and returns through ``np.asarray``)
into the port's tensors and back, bit for bit, and hold the port's device
policy: a torch tensor runs where it lies; anything else goes to the CUDA
card unless the caller names another device, and there is no silent move to
the CPU when the card is missing.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when None. Raises when CUDA is asked for
    and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or a CPU "
            "tensor) to run the plain PyTorch versions on the CPU"
        )
    return dev


def from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """numpy array -> tensor on `device` with the same dtype and bits."""
    arr = np.ascontiguousarray(arr)
    return torch.from_numpy(arr).to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy array with the same dtype and bits (copied to host)."""
    return t.detach().cpu().numpy()


def as_tensor(x, device=None) -> torch.Tensor:
    """Public-function input -> tensor, under the device policy above.

    A tensor stays on its device unless `device` is given; a numpy array
    or sequence goes to `device`, by default the CUDA card.
    """
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return from_numpy(np.asarray(x), device)
