"""The padded layout of the distributed sorts, and the moves into and out of it.

The caller's data is SPMD: every rank of the axis holds one shard, the
global array is the concatenation of the shards in rank order, and the
shards may differ in length. The JAX package's sorts pad the first `count`
elements to ``per * D`` and shard that evenly, ``per = max(128,
next_pow2(cdiv(count, D)))``, with the tie column the global iota: the
real element at global index g < count sits on rank g // per at offset
g % per, and every sentinel pad sits at the global tail. Two things rest on
that: the pads sort after every real element (a real key can be
0xFFFFFFFF like a pad; only the idx column parts them), and the exchange
sort's closed-form tie distribution (idx order among equal keys is shard
order). Padding each shard at its own tail would break both.

So :class:`Layout` builds the same layout: one :func:`comm.all_to_all_v`
going in and one coming back to the caller's shard lengths, both of whose
split sizes follow in closed form from the gathered shard lengths,
`count` and `per`. With equal shards and ``count == n``, per equals the
shard length and both moves are local copies.
"""
from __future__ import annotations

import torch

from ..ops import bitonic, common
from . import comm

LANES = bitonic.LANES


def shard_lengths(n_local: int, group, device) -> list[int]:
    """Every rank's shard length, in rank order (one tiny all_gather)."""
    t = torch.tensor([n_local], dtype=torch.int64, device=device)
    return [int(v) for v in comm.all_gather(t, group).reshape(-1).tolist()]


def padded_length(count: int, n_dev: int) -> int:
    """`per`: each rank's block of the padded layout."""
    return max(LANES, common.next_pow2(common.cdiv(count, n_dev)))


class Layout:
    """Where the real elements (global index < `count`) of the shards go.

    `lengths`: every rank's shard length; `per`: the block length. On this
    rank, `local_real` is how many leading elements of its shard are real,
    and `block_real` how many leading elements of its block are.
    """

    def __init__(self, group, lengths, count: int, per: int):
        self.group = group
        self.me = comm.axis_index(group)
        self.per = per
        d = len(lengths)
        starts = [sum(lengths[:s]) for s in range(d)]
        # sizes[s][b]: real elements of rank s's shard that lie in block b
        self.sizes = []
        for s in range(d):
            lo, hi = starts[s], min(starts[s] + lengths[s], count)
            self.sizes.append([max(0, min(hi, (b + 1) * per) - max(lo, b * per))
                               for b in range(d)])
        self.local_real = sum(self.sizes[self.me])
        self.block_real = sum(row[self.me] for row in self.sizes)

    def _move(self, cols: torch.Tensor, sizes) -> torch.Tensor:
        """(n_cols, m) -> (n_cols, m') through one all_to_all_v of rows."""
        return comm.all_to_all_v(cols.t().contiguous(), sizes, self.group).t().contiguous()

    def block(self, key_cols, payloads, fills) -> torch.Tensor:
        """This rank's block, (n_arr, per) int32: the key columns padded with
        sentinels, the global iota tie, then the payloads padded with
        `fills`. key_cols and payloads are this shard's real prefixes."""
        cols = [*key_cols, *payloads]
        moved = self._move(torch.stack(cols), self.sizes)
        dev = moved.device
        nk = len(key_cols)
        m = self.block_real
        x = torch.empty((len(cols) + 1, self.per), dtype=torch.int32, device=dev)
        x[:nk, :m] = moved[:nk]
        x[:nk, m:] = common.i32(common.SENTINEL_U32)
        torch.arange(self.me * self.per, (self.me + 1) * self.per, dtype=torch.int32,
                     device=dev, out=x[nk])
        for r, fill in enumerate(fills, nk + 1):
            x[r, :m] = moved[r - 1]
            x[r, m:] = common.i32(fill)
        return x

    def back(self, rows: torch.Tensor) -> torch.Tensor:
        """The real prefix of this rank's sorted block, (n_rows, block_real),
        -> the sorted elements at this shard's real positions,
        (n_rows, local_real)."""
        back = [list(col) for col in zip(*self.sizes)]
        return self._move(rows, back)
