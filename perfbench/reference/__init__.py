"""The plain references, one a kind of call, and the byte comparison that
they and the harness's check of the inputs share."""
import torch


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Positions at which `got` differs from `want` in its bytes; every
    position where the shape or size differs."""
    if got.shape != want.shape or got.element_size() != want.element_size():
        return max(got.numel(), want.numel())
    a = got.contiguous().view(torch.uint8).view(got.numel(), -1)
    b = want.contiguous().view(torch.uint8).view(want.numel(), -1)
    return int((a != b).any(dim=1).sum())
