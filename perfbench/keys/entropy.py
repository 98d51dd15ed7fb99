"""Keys of CUB's lower entropy levels: each key the bitwise AND of
``and_words`` uniformly random words, so that a bit is set with probability
2^-and_words (``and_words`` 5: 1/32, Shannon entropy 0.201 a bit, CUB's
Entropy 0.201; 1 is ``uniform``'s Entropy 1.0). As CUB's benchmark
generator makes them for its entropy axis."""
import torch


def make(gen, n, dtype, params, device):
    """`n` keys of `dtype`, each 32-bit word the AND of ``and_words`` random words."""
    nbytes = torch.empty((), dtype=dtype).element_size()
    shape = (-(-n * nbytes // 4),)
    words = torch.randint(-2**31, 2**31, shape, dtype=torch.int32, generator=gen, device=device)
    for _ in range(int(params["and_words"]) - 1):
        words &= torch.randint(-2**31, 2**31, shape, dtype=torch.int32, generator=gen,
                               device=device)
    return words.view(torch.uint8)[: n * nbytes].view(dtype)
