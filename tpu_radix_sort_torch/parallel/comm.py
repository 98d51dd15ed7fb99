"""The collectives of the multi-device layer, over ``torch.distributed``.

The JAX package's ``shard_map`` bodies call ``jax.lax`` collectives over a
mesh axis; here an axis is one process group of a ``DeviceMesh``
(``ops/common.py`` :func:`~..ops.common.mesh_axis`), and this module holds
every collective the layer makes:

- :func:`all_gather`, :func:`psum`: ``all_gather`` / ``all_reduce``;
- :func:`ppermute_start`: a permutation over explicit (source,
  destination) pairs, as async ``batch_isend_irecv`` requests, waited on
  when the data is needed;
- :func:`all_to_all_v`: ``all_to_all_single`` with split sizes, the
  counterpart of ``jax.lax.ragged_all_to_all``.

The transport follows the group's backend, read from
``dist.get_backend(group)``: NCCL takes device tensors as they are; gloo is
handed host copies, and the result is copied back to the tensor's device.
This is the one place where a device tensor goes to the host, and only the
bytes of its collective go there. Peers of the point-to-point calls are
group ranks, converted with ``dist.get_global_rank``, so a subgroup works.
Counts and sums cross as int64 (gloo has no uint32 reduction); u32 bit
patterns cross as their int32 storage.

:data:`STATS` counts what this process exchanged: the bytes it sent to and
received from other ranks, and the host time spent in collectives.
"""
from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist


class Stats:
    """What this process exchanged since :meth:`reset`.

    With `synchronize` set, each collective first waits for the work queued
    on the device, so that `seconds` holds the collectives' own time, and
    (on a CUDA tensor) records a CUDA event pair around itself in `events`.
    """

    def __init__(self):
        self.synchronize = False
        self.reset()

    def reset(self):
        self.calls = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        self.seconds = 0.0
        self.events = []

    def as_dict(self):
        return {"calls": self.calls, "bytes_sent": self.bytes_sent,
                "bytes_received": self.bytes_received, "seconds": self.seconds}


STATS = Stats()


class _Timed:
    """Counts one collective in :data:`STATS`."""

    def __init__(self, device, sent, received, call=True):
        self.device, self.sent, self.received, self.call = device, sent, received, call

    def __enter__(self):
        self.cuda = STATS.synchronize and self.device.type == "cuda"
        if self.cuda:
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.ev[1].record()
            torch.cuda.synchronize(self.device)
            STATS.events.append(self.ev)
        STATS.seconds += time.perf_counter() - self.t0
        STATS.calls += self.call
        STATS.bytes_sent += self.sent
        STATS.bytes_received += self.received
        return False


def _host(group) -> bool:
    """Whether the group's backend takes host tensors (gloo)."""
    return dist.get_backend(group) == "gloo"


def _out(t: torch.Tensor, group) -> torch.Tensor:
    """`t` as the backend takes it: a contiguous host copy for gloo."""
    t = t.contiguous()
    return t.cpu() if _host(group) else t


def _empty(shape, dtype, device, group) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="cpu" if _host(group) else device)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def axis_size(group) -> int:
    return dist.get_world_size(group)


def axis_index(group) -> int:
    return dist.get_rank(group)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `t` (one shape on all ranks), stacked in rank order:
    a (D, *t.shape) tensor on t's device."""
    d = axis_size(group)
    with _Timed(t.device, (d - 1) * _nbytes(t), (d - 1) * _nbytes(t)):
        src = _out(t, group)
        bufs = [torch.empty_like(src) for _ in range(d)]
        dist.all_gather(bufs, src, group=group)
        return torch.stack(bufs).to(t.device)


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks of an integer tensor, in int64, on t's device."""
    d = axis_size(group)
    with _Timed(t.device, (d - 1) * 8 * t.numel(), (d - 1) * 8 * t.numel()):
        s = _out(t.to(torch.int64), group)
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        return s.to(t.device)


class _Pending:
    """The receive of a started :func:`ppermute_start`."""

    def __init__(self, works, buf, like):
        self.works, self.buf, self.like = works, buf, like

    def wait(self) -> torch.Tensor:
        with _Timed(self.like.device, 0, 0, call=False):
            for w in self.works:
                w.wait()
            if self.buf is None:
                return torch.zeros_like(self.like)
            return self.buf.to(self.like.device)


def ppermute_start(t: torch.Tensor, perm, group, tag: int = 0) -> _Pending:
    """Post the send of `t` to this rank's destination in `perm` (pairs of
    group ranks (source, destination), each rank at most once on each side)
    and the receive from its source; ``.wait()`` returns what arrived, on
    t's device, or zeros when no pair sends to this rank (as
    ``jax.lax.ppermute`` fills). Transfers started with distinct `tag`s
    between one pair may be outstanding together."""
    me = axis_index(group)
    dst = [b for a, b in perm if a == me]
    src = [a for a, b in perm if b == me]
    ops, buf = [], None
    with _Timed(t.device, _nbytes(t) * len(dst), _nbytes(t) * len(src)):
        if dst:
            ops.append(dist.P2POp(dist.isend, _out(t, group),
                                  dist.get_global_rank(group, dst[0]), group, tag))
        if src:
            buf = _empty(t.shape, t.dtype, t.device, group)
            ops.append(dist.P2POp(dist.irecv, buf,
                                  dist.get_global_rank(group, src[0]), group, tag))
        works = dist.batch_isend_irecv(ops) if ops else []
    return _Pending(works, buf, t)


def all_to_all_v(t: torch.Tensor, sizes, group) -> torch.Tensor:
    """Ragged all-to-all of the rows of `t` (split along dim 0).

    `sizes[s][d]` is the number of rows rank s sends to rank d, the same
    (D, D) nested list on every rank; this rank sends its rows in
    destination order, contiguous, and receives its chunks contiguous in
    source order, as a (sum of column `me`, *t.shape[1:]) tensor on t's
    device. A diagonal matrix moves nothing between ranks and runs as a
    local copy, with no collective (every rank takes that branch alike).
    """
    d, me = axis_size(group), axis_index(group)
    send = [int(v) for v in sizes[me]]
    recv = [int(sizes[s][me]) for s in range(d)]
    if len(send) != d or sum(send) != t.shape[0]:
        raise ValueError(f"send sizes {send} do not split {t.shape[0]} rows over {d} ranks")
    if all(sizes[s][r] == 0 for s in range(d) for r in range(d) if s != r):
        start = sum(send[:me])
        return t[start:start + send[me]].clone()
    row = t.element_size() * math.prod(t.shape[1:])
    with _Timed(t.device, row * (sum(send) - send[me]), row * (sum(recv) - recv[me])):
        src = _out(t, group)
        out = _empty((sum(recv), *t.shape[1:]), t.dtype, t.device, group)
        dist.all_to_all_single(out, src, output_split_sizes=recv,
                               input_split_sizes=send, group=group)
        return out.to(t.device)
