"""Collectives of the multi-rank layer, the one place that knows the
backend.

The execution model (every module of ``parallel/`` states it): a rank is
a process with one explicit ``torch.device``.  On a machine with several
cards rank r takes ``cuda:r % count`` on an ``nccl`` group; in the tests
rank r takes the CPU on a ``gloo`` group; on a machine with one card W
ranks may share ``cuda:0`` on a ``gloo`` group (NCCL refuses two ranks on
one device).  Gloo's support for CUDA tensors is partial (``send`` /
``recv`` and some gathers take CPU tensors only), so on a ``gloo`` group a
CUDA tensor goes through the host: copied out, reduced or exchanged there,
copied back.  That transport is counted in ``TRANSPORT`` (bytes both
ways, seconds of the whole helper call).  On ``nccl``, and for CPU tensors
on ``gloo``, tensors pass straight through.  Every blend, projection and
update still runs on the rank's device.

The helpers that carry a gradient are ``torch.autograd.Function``s:

- ``all_gather_slabs``: every rank's rows [T_local, ...] into [n·T_local,
  ...]; its backward returns this rank's own slice of the cotangent (the
  loss above the gather is replicated, so every rank holds the same whole
  cotangent: summing would scale every grad by the world size);
- ``sum_grads``: the identity, whose backward sums the grads over the
  group (for the rows a rank's partial work reads: replicated parameters
  below a sharded blend);
- ``ring_shift``: rank i's tensor to rank i + 1 (``jax.lax.ppermute`` with
  ``ring.py``'s ``_ring_perm``); its backward is the reverse shift.

``all_reduce`` (SUM or MAX) and ``broadcast`` carry no gradient.  A group
of size 1 runs its collectives too (so a one-rank ``nccl`` world drives
the ``nccl`` branch of each), except ``ring_shift``, which is then the
identity.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

TRANSPORT = {"host_bytes": 0, "host_seconds": 0.0, "host_calls": 0,
             "calls": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset_transport() -> None:
    TRANSPORT.update(host_bytes=0, host_seconds=0.0, host_calls=0, calls=0)


def _via_host(x: torch.Tensor, group) -> bool:
    """True where the tensor must go through the host: a CUDA tensor on a
    ``gloo`` group."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


class _Host:
    """Times one helper call that goes through the host and counts the
    bytes copied out and back."""

    def __init__(self, active: bool):
        self.active = active

    def __enter__(self):
        TRANSPORT["calls"] += 1
        if self.active:
            self.t0 = time.perf_counter()
        return self

    def out(self, x: torch.Tensor) -> torch.Tensor:
        if not self.active:
            return x
        TRANSPORT["host_bytes"] += x.numel() * x.element_size()
        return x.cpu()

    def back(self, x: torch.Tensor, device: torch.device) -> torch.Tensor:
        if not self.active:
            return x
        TRANSPORT["host_bytes"] += x.numel() * x.element_size()
        return x.to(device)

    def __exit__(self, *exc):
        if self.active:
            TRANSPORT["host_seconds"] += time.perf_counter() - self.t0
            TRANSPORT["host_calls"] += 1
        return False


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """A new tensor: ``x`` reduced over the group with ``op`` ("sum" or
    "max").  Bool tensors reduce as int32 ("max" is their union)."""
    dev, dtype = x.device, x.dtype
    buf = x.to(torch.int32) if dtype == torch.bool else x.clone()
    with _Host(_via_host(x, group)) as h:
        buf = h.out(buf.contiguous())
        dist.all_reduce(buf, op=_OPS[op], group=group)
        buf = h.back(buf, dev)
    return buf.to(dtype) if dtype == torch.bool else buf


def all_reduce_flat(xs: list[torch.Tensor], op: str = "sum",
                    group=None) -> list[torch.Tensor]:
    """``all_reduce`` of several float tensors of one device in one call
    (flattened and concatenated as float32); returns them in their shapes
    and dtypes."""
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in xs])
    red = all_reduce(flat, op, group)
    out, at = [], 0
    for x in xs:
        n = x.numel()
        out.append(red[at:at + n].reshape(x.shape).to(x.dtype))
        at += n
    return out


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """A new tensor: ``x`` of the group's rank ``src`` (a rank of the
    group) on every rank."""
    dev, dtype = x.device, x.dtype
    buf = x.to(torch.int32) if dtype == torch.bool else x.clone()
    with _Host(_via_host(x, group)) as h:
        buf = h.out(buf.contiguous())
        dist.broadcast(buf, src=dist.get_global_rank(group, src)
                       if group is not None else src, group=group)
        buf = h.back(buf, dev)
    return buf.to(dtype) if dtype == torch.bool else buf


class _AllGatherSlabs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        with _Host(_via_host(x, group)) as h:
            buf = h.out(x.contiguous())
            parts = [torch.empty_like(buf)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, buf, group=group)
            return h.back(torch.cat(parts), x.device)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows], None


def all_gather_slabs(x: torch.Tensor, group=None) -> torch.Tensor:
    """[T_local, ...] rows of every rank -> [n·T_local, ...] in rank order.
    Backward: this rank's own slice of the (replicated) cotangent."""
    return _AllGatherSlabs.apply(x, group)


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.shapes = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        need = [i for i, n in enumerate(ctx.needs_input_grad[1:]) if n]
        grads = [None] * len(gs)
        if not need:
            return (None, *grads)
        full = [gs[i] if gs[i] is not None else torch.zeros(
            ctx.shapes[i][0], dtype=ctx.shapes[i][1], device=ctx.shapes[i][2])
            for i in need]
        for i, g in zip(need, all_reduce_flat(full, "sum", ctx.group)):
            grads[i] = g
        return (None, *grads)


def sum_grads(group, *xs):
    """The identity on ``xs``; the backward sums each grad over the group
    (one collective for all of them).  ``None`` entries pass through.
    Returns a tuple like ``xs``."""
    live = [i for i, x in enumerate(xs) if x is not None]
    out = list(xs)
    got = _SumGrads.apply(group, *(xs[i] for i in live))
    for i, y in zip(live, got):
        out[i] = y
    return tuple(out)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Rank i's ``x`` to rank i + ``step`` (mod n) of the group: one
    ``batch_isend_irecv`` with the send and the receive of the stage
    posted together."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    r = dist.get_rank(group)
    dev = x.device
    with _Host(_via_host(x, group)) as h:
        buf = h.out(x.detach().contiguous())
        recv = torch.empty_like(buf)

        def peer(i):
            i %= n
            return dist.get_global_rank(group, i) if group is not None else i

        ops = [dist.P2POp(dist.isend, buf, peer(r + step), group),
               dist.P2POp(dist.irecv, recv, peer(r - step), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = h.back(recv, dev)
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.group, -1), None


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rank i's ``x`` to rank i + 1 of the group (every rank sends and
    receives one tensor of one shape); the backward shifts the cotangent
    back to rank i - 1."""
    return _RingShift.apply(x, group)
