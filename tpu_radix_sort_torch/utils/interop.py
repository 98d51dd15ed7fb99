"""Carrying state between the JAX package's numpy arrays and the port.

The sort has no weights: its state is its input buffers. These functions map
numpy arrays (what the JAX package takes and returns through ``np.asarray``)
into the port's tensors and back, bit for bit, and hold the port's device
policy: a torch tensor runs where it lies; anything else goes to the CUDA
card unless the caller names another device, and there is no silent move to
the CPU when the card is missing.

bfloat16 crosses as its bits: numpy has no bfloat16, ``torch.from_numpy``
refuses an ``ml_dtypes.bfloat16`` array and ``Tensor.numpy()`` refuses a
``torch.bfloat16`` tensor. So an ``ml_dtypes.bfloat16`` array (recognised by
its dtype's name, without importing ``ml_dtypes``) becomes a
``torch.bfloat16`` tensor of the same bits, and a ``torch.bfloat16`` tensor
comes back as a ``uint16`` array of its bit patterns.
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
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy array with the same dtype and bits (copied to host);
    bfloat16 as a uint16 array of its bit patterns."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def as_tensor(x, device=None) -> torch.Tensor:
    """Public-function input -> tensor, under the device policy above.

    A tensor stays on its device unless `device` is given; a numpy array
    or sequence goes to `device`, by default the CUDA card.
    """
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return from_numpy(np.asarray(x), device)
