"""Differentiable collectives over one axis of the mesh: the port's
counterparts of ``lax.psum``, ``lax.ppermute`` (a ring shift) and
``lax.all_gather`` inside the reference's ``shard_map`` bodies.

The reference differentiates through its collectives (the sharded
retrieval vmaps ``jax.jvp`` through the ``shard_map``), while
``torch.func`` sees nothing of a bare ``torch.distributed`` call.  So each
collective is a ``torch.autograd.Function`` with a forward, a ``jvp``, a
``backward`` and a ``vmap`` rule.  All three are linear:

- the tangent goes through the same collective (``jvp``);
- the cotangent through its transpose (``backward``): a sum stays a sum, a
  shift by k becomes a shift by -k, a gather becomes a sum and this rank's
  slice of it;
- a batch (the tangents of ``torch.func.jacfwd``) goes through the
  collective in one call, with the batch dimension carried along (``vmap``).

Every rank must make the same collective calls in the same order: each
function here is called by all ranks of the axis's group.

Beside them, :func:`ring_exchange_start` and :meth:`Pending.wait` split a
ring exchange of constants in two, as XLA schedules the reference's
``collective-permute-start``/``-done`` pairs: every hop's messages are
issued at once, the caller runs independent work, and only then does the
current stream wait for the exchange.  They carry no tangent rule: the
nu-halo tier's line parameters are constants on every path.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist
from torch._C._functorch import is_functorch_wrapped_tensor


class _AllReduce(torch.autograd.Function):
    """Sum over the ranks of ``group``; every rank gets the sum."""

    @staticmethod
    def forward(x, group):
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def jvp(ctx, t, _):
        return _AllReduce.apply(t, ctx.group)

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _AllReduce.apply(x, group), in_dims[0]


class _RingShift(torch.autograd.Function):
    """Rank i of ``group`` sends its tensor to rank (i + shift) mod n and
    receives that of rank (i - shift) mod n."""

    @staticmethod
    def forward(x, group, shift):
        x = x.detach().contiguous()
        n = dist.get_world_size(group)
        if shift % n == 0:
            return x.clone()
        r = dist.get_rank(group)
        out = torch.empty_like(x)
        peer = lambda k: dist.get_global_rank(group, k % n)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, peer(r + shift), group),
            dist.P2POp(dist.irecv, out, peer(r - shift), group)])
        for req in reqs:
            req.wait()
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.shift = inputs[1], inputs[2]

    @staticmethod
    def jvp(ctx, t, _g, _s):
        return _RingShift.apply(t, ctx.group, ctx.shift)

    @staticmethod
    def backward(ctx, g):
        return _RingShift.apply(g, ctx.group, -ctx.shift), None, None

    @staticmethod
    def vmap(info, in_dims, x, group, shift):
        return _RingShift.apply(x, group, shift), in_dims[0]


class _AllGather(torch.autograd.Function):
    """The ranks' tensors concatenated along ``dim`` in rank order; every
    rank gets the whole."""

    @staticmethod
    def forward(x, group, dim):
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.detach().contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.dim = inputs[1], inputs[2]
        ctx.n = inputs[0].shape[inputs[2]]

    @staticmethod
    def jvp(ctx, t, _g, _d):
        return _AllGather.apply(t, ctx.group, ctx.dim)

    @staticmethod
    def backward(ctx, g):
        g = _AllReduce.apply(g, ctx.group)
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n), None, None

    @staticmethod
    def vmap(info, in_dims, x, group, dim):
        if in_dims[0] is None:
            return _AllGather.apply(x, group, dim), None
        return _AllGather.apply(x.movedim(in_dims[0], 0), group, dim + 1), 0


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``lax.psum(x, axes)``: the sum of ``x`` over the ranks of the mesh
    axis or axes ``axes`` (one all-reduce per axis)."""
    for ax in (axes,) if isinstance(axes, str) else axes:
        x = _AllReduce.apply(x, mesh.groups[ax])
    return x


def ring_shift(x: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    """``lax.ppermute(x, axis, [(i, (i + shift) % n)])``: each rank gets the
    ``x`` of the rank ``shift`` places before it on the ring of ``axis``."""
    return _RingShift.apply(x, mesh.groups[axis], int(shift))


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``: the blocks of the
    ranks of ``axis`` concatenated along ``dim`` in mesh order."""
    if dim < 0:
        raise ValueError("all_gather takes a non-negative dim")
    return _AllGather.apply(x, mesh.groups[axis], int(dim))


class Pending:
    """A ring exchange in flight (:func:`ring_exchange_start`).  It holds
    the send buffers until :meth:`wait`: the exchange reads them on its
    own stream (NCCL) or thread (gloo)."""

    def __init__(self, works, sends, recvs):
        self._works, self._sends, self._recvs = works, sends, recvs

    def wait(self) -> List[List[torch.Tensor]]:
        """Make the current stream (gloo: the host) wait for the exchange;
        the received messages, by hop and by message, each a stack of the
        sender's parts."""
        with torch._C._DisableFuncTorch():
            for work in self._works:
                work.wait()
        self._works = self._sends = ()
        return self._recvs


def _check_constant(t: torch.Tensor) -> None:
    if (is_functorch_wrapped_tensor(t) or t.requires_grad
            or torch.autograd.forward_ad.unpack_dual(t).tangent is not None):
        raise ValueError(
            "ring_exchange_start takes constants only: this input carries a "
            "tangent, a vmap batch or requires grad (use ring_shift, which "
            "differentiates)")


def ring_exchange_start(tensors: Sequence[Sequence[torch.Tensor]], mesh,
                        axis: str, shifts: Sequence[int]) -> Pending:
    """Issue the ring shifts ``shifts`` of every message at once and return
    without blocking the host; :meth:`Pending.wait` gives, for each shift,
    each message as ``ring_shift`` would (the message of the rank ``shift``
    places before this one on the ring of ``axis``).

    A message is a sequence of tensors of one dtype and shape, sent as
    their stack: one send and one receive a message and hop, all in one
    ``batch_isend_irecv`` (one grouped launch on NCCL, whose stream waits
    for the packing).  Every rank of the ring must call it with the same
    shifts and messages of the same shapes, in the same order.  The parts
    must be constants (no ``torch.func`` wrapper, no ``requires_grad``):
    a ValueError otherwise.  No shift gives no exchange at all."""
    if not shifts:
        return Pending((), (), [])
    for msg in tensors:
        for t in msg:
            _check_constant(t)
    group = mesh.groups[axis]
    n, r = dist.get_world_size(group), dist.get_rank(group)
    peer = lambda k: dist.get_global_rank(group, k % n)
    with torch._C._DisableFuncTorch():
        sends = [torch.stack(tuple(msg)) for msg in tensors]
        ops, recvs = [], []
        for shift in shifts:
            if shift % n == 0:
                recvs.append([x.clone() for x in sends])
                continue
            got = [torch.empty_like(x) for x in sends]
            for x, out in zip(sends, got):
                ops += [dist.P2POp(dist.isend, x, peer(r + shift), group),
                        dist.P2POp(dist.irecv, out, peer(r - shift), group)]
            recvs.append(got)
        works = dist.batch_isend_irecv(ops) if ops else []
    return Pending(works, sends, recvs)
