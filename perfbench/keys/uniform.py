"""Keys whose every bit is uniformly random (CUB's Entropy 1.0)."""
import torch


def make(gen, n, dtype, params, device):
    """`n` keys of `dtype`, drawn as random 32-bit words on `device`."""
    nbytes = torch.empty((), dtype=dtype).element_size()
    words = torch.randint(-2**31, 2**31, (-(-n * nbytes // 4),), dtype=torch.int32,
                          generator=gen, device=device)
    return words.view(torch.uint8)[: n * nbytes].view(dtype)
