"""Keys of one rendered frame of 3D Gaussian Splatting: a u64 key for each
(Gaussian, tile) instance, ``(tile_id << 32) | float32 bits of the depth``.

The steps are those of the rasterizer of Kerbl et al., SIGGRAPH 2023
(``graphdeco-inria/diff-gaussian-rasterization``,
``cuda_rasterizer/``): each visible Gaussian has a screen centre, a radius
``ceil(3 sigma)`` in pixels and a depth; ``getRect`` turns centre and radius
into a rectangle of 16 x 16-pixel tiles, clamped to the grid; an empty
rectangle gives no instance; ``duplicateWithKeys`` writes one key for each
tile of the rectangle, Gaussian after Gaussian, row after row, column after
column.

Gaussians are drawn on the device from the generator, in batches of
``batch``, until their instances cover `n`; the last Gaussian's instances
are cut so that exactly `n` remain. The traffic file gives every law:
centres uniform over the image widened by ``margin`` of its size on each
side, sigma log-normal (``sigma_median_px``, ``sigma_log_sd``), the radius
capped at ``radius_max_px``, depths log-uniform over ``depth_range``.
"""
import math

import torch


def grid(params):
    """(columns, rows) of the frame's tile grid."""
    (w, h), t = params["image_px"], params["tile_px"]
    return (w + t - 1) // t, (h + t - 1) // t


def gaussians(gen, count, params, device):
    """One batch of `count` Gaussians on the screen: centres x and y (float32
    pixels), radii (int64 pixels) and depths (float32, within ``depth_range``)."""
    (w, h), m = params["image_px"], params["margin"]
    u = torch.rand((2, count), generator=gen, device=device)
    px = (u[0] * (1 + 2 * m) - m) * w
    py = (u[1] * (1 + 2 * m) - m) * h
    sigma = params["sigma_median_px"] * torch.exp(
        params["sigma_log_sd"] * torch.randn(count, generator=gen, device=device))
    radius = torch.ceil(params["radius_sigmas"] * sigma).clamp_(max=params["radius_max_px"])
    lo, hi = params["depth_range"]
    t = torch.rand(count, generator=gen, device=device)
    depth = torch.exp(math.log(lo) + t * (math.log(hi) - math.log(lo))).clamp_(lo, hi)
    return px, py, radius.to(torch.int64), depth


def rects(px, py, radius, params):
    """``getRect``: each Gaussian's tiles [x0, x1) x [y0, y1), clamped to the grid,
    from float32 arithmetic truncated to integers as the source's casts do."""
    t = params["tile_px"]
    r = radius.to(torch.float32)

    def span(p, g):
        lo = torch.trunc((p - r) / t).clamp_(0, g)
        hi = torch.trunc((p + r + t - 1) / t).clamp_(0, g)
        return lo.to(torch.int64), hi.to(torch.int64)

    gx, gy = grid(params)
    (x0, x1), (y0, y1) = span(px, gx), span(py, gy)
    return x0, y0, x1, y1


def instances(gen, n, params, device):
    """The frame's first `n` instances in ``duplicateWithKeys`` order: their
    tile ids (int64), depths (float32) and Gaussians (int64, in draw order)."""
    batches, total = [], 0
    while total < n:
        px, py, radius, depth = gaussians(gen, int(params["batch"]), params, device)
        x0, y0, x1, y1 = rects(px, py, radius, params)
        count = (x1 - x0) * (y1 - y0)
        batches.append((x0, y0, x1 - x0, count, depth))
        total += int(count.sum())
    x0, y0, width, count, depth = (torch.cat(parts) for parts in zip(*batches))
    ends = count.cumsum(0)
    kept = int(torch.searchsorted(ends, n)) + 1  # the Gaussian whose instances reach n
    starts = ends[:kept] - count[:kept]
    count = count[:kept].clone()
    count[-1] -= int(ends[kept - 1]) - n
    gaussian = torch.repeat_interleave(torch.arange(kept, device=device), count,
                                       output_size=n)
    local = torch.arange(n, device=device) - starts[gaussian]  # the instance's place in its rect
    w = width[gaussian]
    gx, _ = grid(params)
    tile = (y0[gaussian] + local // w) * gx + x0[gaussian] + local % w
    return tile, depth[gaussian], gaussian


def make(gen, n, dtype, params, device):
    """`n` keys of `dtype`: the (tile << 32) | depth bits words, or, for a
    narrower dtype, their low bytes."""
    tile, depth, _ = instances(gen, n, params, device)
    words = (tile << 32) | depth.view(torch.int32).to(torch.int64)
    nbytes = torch.empty((), dtype=dtype).element_size()
    return words.view(torch.uint8).view(n, 8)[:, :nbytes].contiguous().view(dtype).view(n)
