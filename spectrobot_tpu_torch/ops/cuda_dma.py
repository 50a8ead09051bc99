"""The nu ring's remote-copy tier on the card: the wrappers of the
hand-written CUDA kernels ``csrc/dma_ring.cu`` and ``csrc/dma_halo.cu`` and
their plain PyTorch versions.

The kernels replace the TPU kernels of ``benchmarks/dma_halo.py``:

- ``_ring_kernel`` (:func:`ring_exchange_cuda`): each shard's block moves
  to its ring neighbour at ``direction`` by stores into the neighbour's
  memory, a roll of the blocks over the shards;
- ``_fused_kernel`` (:func:`fused_halo_accumulate_cuda`): a neighbour
  barrier, the remote stores of the shard's packed line rows to both
  neighbours, the line sum of its own lines while they fly, then the wait
  and the line sum of the received halos, in one launch.

Both take a :class:`~spectrobot_tpu_torch.parallel.peer.Ring`: on a ring of
ranks a tensor is this rank's block; on the loopback ring a tensor holds
every shard's block along a leading axis, and one launch covers them all.

What bounds them on an H100: the ring, bytes (NVLink's 450 GB/s each way
between cards, 3.35 TB/s of device memory on the loopback); the fused
kernel, FP32 arithmetic on the in-cutoff pairs, as K3 (whose work item and
ordered partial sums it runs, ``csrc/line_sum_item.cuh``).

Device rule: a CPU tensor goes to the plain version (``torch.roll`` on the
loopback, ``parallel.collectives.ring_shift`` on a ring of ranks; the
line sums through ``ops.opacity.accumulate_plain`` as
``parallel/halo.py:halo_accumulate_fn`` composes them); a CUDA tensor
always launches the kernel, and a build or launch failure raises.  A lost
peer makes the kernel trap after ``parallel.peer.TIMEOUT_S``: a CUDA error
at the next synchronisation, not a hang.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from spectrobot_tpu_torch.ops.cuda_opacity import BLOCK_L, TILE_P
from spectrobot_tpu_torch.ops.cuda_single import (
    MAX_OUT, current_stream, split_blocks)
from spectrobot_tpu_torch.ops.opacity import accumulate_plain
from spectrobot_tpu_torch.parallel import peer
from spectrobot_tpu_torch.parallel.collectives import ring_shift
from spectrobot_tpu_torch.parallel.halo import (
    _hops, halo_accumulate_fn, pack_lines, unpack_lines)
from spectrobot_tpu_torch.parallel.peer import (
    CHUNK_FLOATS, TIMEOUT_S, Ring, ring_chunk)

# Pads of the packed rows: a far center, wide and zero-amplitude.
PAD_ROWS = (1e9, 1e6, 1e6)

# Kernel launches made by the wrappers in this process.
RING_LAUNCHES = 0
HALO_LAUNCHES = 0
_LIB = None


def _library() -> ctypes.CDLL:
    """The fused kernel's library, built and bound on first use (the ring
    kernel's is ``parallel.peer.library``).  Its tile, block and row limit
    are K3's: both kernels include ``csrc/line_sum_item.cuh``."""
    global _LIB
    if _LIB is None:
        from spectrobot_tpu_torch.kernels import build

        lib = build.load("dma_halo")
        ptr, i32, i64, u64 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_ulonglong)
        lib.dma_halo_launch.argtypes = [
            i32, ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, i32,
            i32, i32, ctypes.c_float, i32, u64, ctypes.c_float, i32, ptr]
        lib.dma_halo_launch.restype = i32
        lib.dma_halo_error_string.argtypes = [i32]
        lib.dma_halo_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(lib, name: str, rc: int) -> None:
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _direction_index(direction: int) -> int:
    if direction not in (1, -1):
        raise ValueError(f"direction must be +1 or -1, got {direction}")
    return 0 if direction == 1 else 1


def _check_ring_tensor(ring: Ring, t: torch.Tensor, name: str,
                       dims: int) -> None:
    """A ring tensor has ``dims`` dimensions per shard, and on the
    loopback a leading axis of the ring's shards."""
    want = dims + (1 if ring.loopback else 0)
    if t.dim() != want or (ring.loopback and t.shape[0] != ring.n):
        lead = f"[{ring.n}, ...] " if ring.loopback else ""
        raise ValueError(f"{name} must be {lead}{dims}-D per shard on this "
                         f"ring, got {tuple(t.shape)}")


def _check_kernel_tensor(ring: Ring, t: torch.Tensor, name: str) -> None:
    if (t.is_cuda and t.get_device() == ring.device.index
            and t.dtype is torch.float32 and t.is_contiguous()):
        return
    if t.device.type != "cuda":
        raise ValueError(f"no remote-copy kernel for device {t.device}")
    if t.device != ring.device:
        raise ValueError(f"{name} is on {t.device}, the ring on "
                         f"{ring.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# ---------------------------------------------------------------------------
# The ring exchange
# ---------------------------------------------------------------------------


def ring_exchange_plain(ring: Ring, x: torch.Tensor,
                        direction: int) -> torch.Tensor:
    """The plain version of :func:`ring_exchange_cuda`, any dtype and
    device: the roll of the blocks over the shards."""
    if ring.loopback:
        return torch.roll(x, direction, 0)
    return ring_shift(x, ring.mesh, "nu", direction)


def ring_exchange_cuda(ring: Ring, x: torch.Tensor,
                       direction: int = 1) -> torch.Tensor:
    """Each shard's 2-D block moved to the shard at ``direction`` (+1: each
    receives its left neighbour's block): ``x`` [rows, cols] on a ring of
    ranks, [n, rows, cols] on the loopback ring; float32 on the card, any
    dtype on the CPU (the plain version)."""
    global RING_LAUNCHES
    d = _direction_index(direction)
    _check_ring_tensor(ring, x, "x", 2)
    n_floats = x.numel() // ring.n if ring.loopback else x.numel()
    if not x.is_cuda and x.device.type == "cpu":
        ring.begin_call()
        return ring_exchange_plain(ring, x, direction)
    _check_kernel_tensor(ring, x, "x")
    if n_floats == 0:
        raise ValueError("the ring exchange takes a non-empty block")
    lib = peer.library()
    ring.sync_once("dma_ring")
    args = ring.workspace_for(n_floats).ring_args
    out = torch.empty_like(x)
    args.x, args.out = x.data_ptr(), out.data_ptr()
    args.n, args.d = n_floats, d
    args.chunk = ring_chunk(n_floats, args.n_loc)
    args.epoch = ring.begin_call()
    args.stream = current_stream(args.device)
    rc = lib.dma_ring_launch(ctypes.byref(args))
    RING_LAUNCHES += 1
    _raise_on(lib, "dma_ring", rc)
    return out


# ---------------------------------------------------------------------------
# The fused halo accumulation
# ---------------------------------------------------------------------------


def fused_halo_accumulate_plain(ring: Ring, nu: torch.Tensor,
                                packed: torch.Tensor, *,
                                cutoff_cm1: Optional[float] = 25.0
                                ) -> torch.Tensor:
    """The plain version of :func:`fused_halo_accumulate_cuda`, any dtype
    and device: the own lines plus each hop's lines, through
    ``accumulate_plain`` (``parallel/halo.py:halo_accumulate_fn``'s
    composition; on the loopback the hops are rolls over the shards)."""
    if not ring.loopback:
        return halo_accumulate_fn(ring.mesh, cutoff_cm1=cutoff_cm1)(
            nu, unpack_lines(packed))

    def acc(nu_k, rows):
        return accumulate_plain(nu_k, unpack_lines(rows),
                                cutoff_cm1=cutoff_cm1)

    hops = [torch.roll(packed, shift, 0) for shift, _ in _hops(ring.n)]
    outs = []
    for k in range(ring.n):
        out = acc(nu[k], packed[k])
        for got in hops:
            out = out + acc(nu[k], got[k])
        outs.append(out)
    return torch.stack(outs)


def _pad_points(nu: torch.Tensor, Pp: int) -> torch.Tensor:
    """The grid chunks padded to Pp points with their last point (the pads'
    sums are dropped; the tile bounds stay the chunk's)."""
    P = nu.shape[-1]
    if Pp == P:
        return nu.contiguous()
    return torch.cat([nu, nu[..., -1:].expand(*nu.shape[:-1], Pp - P)],
                     dim=-1).contiguous()


def _pad_lines(packed: torch.Tensor, Lp: int) -> torch.Tensor:
    L = packed.shape[-1]
    if Lp == L:
        return packed.contiguous()
    pad = torch.zeros(packed.shape[:-1] + (Lp - L,), dtype=packed.dtype,
                      device=packed.device)
    for r, v in enumerate(PAD_ROWS):
        pad[..., r, :] = v
    return torch.cat([packed, pad], dim=-1).contiguous()


def fused_halo_accumulate_cuda(ring: Ring, nu: torch.Tensor,
                               packed: torch.Tensor, *,
                               cutoff_cm1: Optional[float] = 25.0
                               ) -> torch.Tensor:
    """The halo accumulation of a ``nu`` ring in one launch: ``nu`` [P_loc]
    (this rank's grid chunk) and ``packed`` [3 + n_out, L] (its own lines,
    ``parallel.halo.pack_lines``) on a ring of ranks -> [n_out, P_loc]; on the
    loopback every shard's: [n, P_loc] and [n, 3 + n_out, L] -> [n, n_out,
    P_loc].  Each shard sums its own lines and its neighbours' (the left
    one's only, with two shards) at its chunk, with the |dnu| <= cutoff
    mask (``cutoff_cm1=None``: none).  float32 with 1 <= n_out <=
    ``MAX_OUT`` on the card; any dtype on the CPU (the plain version)."""
    global HALO_LAUNCHES
    _check_ring_tensor(ring, nu, "nu", 1)
    _check_ring_tensor(ring, packed, "packed", 2)
    q, L, P = packed.shape[-2], packed.shape[-1], nu.shape[-1]
    n_out = q - 3
    if n_out < 1:
        raise ValueError(f"packed rows are [3 + n_out, L], got "
                         f"{tuple(packed.shape)}")
    if packed.device != nu.device:
        raise ValueError(f"packed is on {packed.device}, nu on {nu.device}")
    Lp = -(-max(L, 1) // BLOCK_L) * BLOCK_L
    dirs = ring.directions
    if nu.device.type == "cpu":
        ring.begin_call()
        return fused_halo_accumulate_plain(ring, nu, packed,
                                           cutoff_cm1=cutoff_cm1)
    for name, t in (("nu", nu), ("packed", packed)):
        _check_kernel_tensor(ring, t, name)
    if n_out > MAX_OUT:
        raise ValueError(f"the kernel takes 1 to {MAX_OUT} amplitude rows, "
                         f"got {n_out}")
    lib = _library()
    ring.sync_once("dma_halo")
    ws = ring.workspace_for(q * Lp)
    epoch = ring.begin_call()
    n_loc = ring.local_shards
    Pp = -(-P // TILE_P) * TILE_P
    nu_d = _pad_points(nu, Pp)
    pack_d = _pad_lines(packed, Lp)
    n_src = 1 + len(dirs)
    n_seg, seg_blocks = split_blocks(n_loc * n_src * (Pp // TILE_P),
                                     Lp // BLOCK_L)
    dev = nu.device
    part = torch.empty((n_loc, n_src * n_seg, n_out, Pp),
                       dtype=torch.float32, device=dev)
    out = torch.empty((n_loc, n_out, Pp), dtype=torch.float32, device=dev)
    cut = math.inf if cutoff_cm1 is None else float(cutoff_cm1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dma_halo_launch(
            dev.index, ws.table.data_ptr(), nu_d.data_ptr(),
            pack_d.data_ptr(), part.data_ptr(), out.data_ptr(),
            ws.cap_floats, n_loc, n_out, Pp, Lp, len(dirs), n_seg,
            seg_blocks, cut, CHUNK_FLOATS, epoch, TIMEOUT_S,
            int(ring.loopback), stream)
        HALO_LAUNCHES += 1
    _raise_on(lib, "dma_halo", rc)
    out = out[..., :P]
    return out if ring.loopback else out[0]
