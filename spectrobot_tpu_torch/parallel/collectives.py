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
nu-halo tier's line parameters are constants on every path.  Under a CUDA
graph's capture (``parallel.graphed``) the exchange is issued from a
stream of its own, so that it is a branch of the graph beside the
caller's work, and it leaves NCCL: :func:`capture_exchange` sends every
hop's messages by one launch of the port's ring kernel
(``parallel.cuda_dma.ring_exchange_hops``, ``csrc/dma_ring.cu``) over the
mesh's capture ring (``Mesh.capture_ring``: the ranks of the ``nu``
group, peer memory, epochs counted on the card).  NCCL offers no
per-communicator switch for its support of graphs mixed with eager
calls, and with it on, a captured send/receive started only after the
own line sum; every eager call, this module's collectives and the
eager exchange keep ``mesh.groups``.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch._C._functorch import is_functorch_wrapped_tensor

from spectrobot_tpu_torch.utils.profiling import annotate


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


# The profiler ranges (``utils.profiling.annotate``) of an exchange's issue
# and of the own line sum it overlaps (``halo_overlap``'s host marks).
EXCHANGE_RANGE = "ring_exchange_issue"
OWN_SUM_RANGE = "halo_own_line_sum"

class Pending:
    """A ring exchange in flight (:func:`ring_exchange_start`).  It holds
    the send buffers until :meth:`wait`: the exchange reads them on its
    own stream (NCCL; a captured exchange's ring kernel: the stream it was
    issued from) or thread (gloo)."""

    def __init__(self, works, sends, recvs, stream=None):
        self._works, self._sends, self._recvs = works, sends, recvs
        self._stream = stream

    def wait(self) -> List[List[torch.Tensor]]:
        """Make the current stream (gloo: the host) wait for the exchange,
        and for the stream it was issued from; the received messages, by
        hop and by message, each a stack of the sender's parts."""
        with torch._C._DisableFuncTorch():
            for work in self._works:
                work.wait()
        if self._stream is not None:
            torch.cuda.current_stream(self._stream.device).wait_stream(
                self._stream)
        self._works = self._sends = ()
        return self._recvs


def is_constant(t: torch.Tensor) -> bool:
    """Whether ``t`` is a constant: no ``torch.func`` wrapper, no
    ``requires_grad`` and no forward-AD tangent."""
    return not (is_functorch_wrapped_tensor(t) or t.requires_grad
                or torch.autograd.forward_ad.unpack_dual(t).tangent
                is not None)


def _check_constant(t: torch.Tensor) -> None:
    if not is_constant(t):
        raise ValueError(
            "ring_exchange_start takes constants only: this input carries a "
            "tangent, a vmap batch or requires grad (use ring_shift, which "
            "differentiates)")


def ring_exchange_start(tensors: Sequence[Sequence[torch.Tensor]], mesh,
                        axis: str, shifts: Sequence[int],
                        stream: Optional[torch.cuda.Stream] = None
                        ) -> Pending:
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
    a ValueError otherwise.  No shift gives no exchange at all.

    ``stream`` (a CUDA stream; ``parallel.graphed`` passes one under a
    capture): the exchange is :func:`capture_exchange` over
    ``mesh.capture_ring`` (``axis`` must be ``nu``), issued from
    ``stream`` after it waits for the packing on the current stream, so
    that it forks from the caller's work; :meth:`Pending.wait` joins it
    back.  Otherwise NCCL (gloo) on ``mesh.groups[axis]`` from the current
    stream; on the card that call also readies the capture ring for
    messages of this size (``Ring.reserve``: a handshake over the ``nu``
    group when the ring must grow), since a capture of the same call may
    follow, and may not open it."""
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
        if stream is not None and torch.cuda.is_current_stream_capturing():
            if axis != "nu":
                raise ValueError(f"a captured exchange runs on the nu "
                                 f"capture ring, not on {axis!r}")
            return capture_exchange(sends, mesh.capture_ring, shifts, stream)
        if sends[0].is_cuda and axis == "nu" and any(
                shift % n for shift in shifts):
            mesh.capture_ring.reserve(packed_floats(sends))
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
        with annotate(EXCHANGE_RANGE):
            works = dist.batch_isend_irecv(ops) if ops else []
    return Pending(works, sends, recvs)


# Each message's bytes in a packed exchange start on this boundary (so
# that every dtype's view of them is aligned).
PACK_ALIGN = 16


def _padded(nbytes: int) -> int:
    return -(-nbytes // PACK_ALIGN) * PACK_ALIGN


def packed_floats(sends: Sequence[torch.Tensor]) -> int:
    """The float32 words of :func:`pack_messages`' buffer."""
    return sum(_padded(x.numel() * x.element_size()) for x in sends) // 4


def pack_messages(sends: Sequence[torch.Tensor]) -> torch.Tensor:
    """The bytes of every message (each contiguous), each padded to
    ``PACK_ALIGN``, as one float32 row [1, packed_floats]: what the ring
    kernel moves, bit for bit, whatever the messages' dtypes."""
    parts = []
    for x in sends:
        b = x.reshape(-1).view(torch.uint8)
        parts.append(b)
        pad = _padded(b.numel()) - b.numel()
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8,
                                     device=b.device))
    return torch.cat(parts).view(torch.float32).reshape(1, -1)


def unpack_messages(row: torch.Tensor,
                    sends: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Views of a packed row [packed_floats] (:func:`pack_messages`) as
    messages of the dtypes and shapes of ``sends``."""
    b, off, out = row.reshape(-1).view(torch.uint8), 0, []
    for x in sends:
        nbytes = x.numel() * x.element_size()
        out.append(b[off:off + nbytes].view(x.dtype).reshape(x.shape))
        off += _padded(nbytes)
    return out


def capture_exchange(sends: Sequence[torch.Tensor], ring,
                     shifts: Sequence[int],
                     stream: Optional[torch.cuda.Stream] = None) -> Pending:
    """The exchange of a captured mesh body: the messages ``sends`` (each a
    stacked message) packed into one row (:func:`pack_messages`) and moved
    by one ring kernel launch in every direction of ``shifts`` (each +1 or
    -1: the ring's neighbours) over ``ring``, the mesh's capture ring,
    from ``stream`` as :func:`ring_exchange_start` issues it.  The ring
    must be reserved for the row (``Ring.reserve``: the eager call before
    a capture does it).  Received messages as ``ring_exchange_start``
    gives them, views of the launch's output.  On the CPU the ring's plain
    version (``ring_shift`` over the ``nu`` group) moves the row."""
    # Imported here: parallel.cuda_dma imports this module.
    from spectrobot_tpu_torch.parallel.cuda_dma import ring_exchange_hops

    shifts = tuple(int(s) for s in shifts)
    x = pack_messages(sends)
    fork = contextlib.nullcontext()
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        fork = torch.cuda.stream(stream)
    with fork, annotate(EXCHANGE_RANGE):
        out = ring_exchange_hops(ring, x, shifts)
    recvs = [unpack_messages(out[i], sends) for i in range(len(shifts))]
    return Pending((), (x, out), recvs, stream)
