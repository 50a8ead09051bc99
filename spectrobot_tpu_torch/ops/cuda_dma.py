"""The nu ring's remote-copy tier on the card: the wrappers of the
hand-written CUDA kernels ``csrc/dma_ring.cu`` and ``csrc/dma_halo.cu`` and
their plain PyTorch versions.

The kernels replace the TPU kernels of ``benchmarks/dma_halo.py``:

- ``_ring_kernel`` (:func:`ring_exchange_cuda`; :func:`ring_exchange_hops`
  for both directions in one launch): each shard's block moves to its ring
  neighbour at ``direction`` by stores into the neighbour's memory, a roll
  of the blocks over the shards;
- ``_fused_kernel`` (:func:`fused_halo_accumulate_cuda`, and
  :func:`fused_halo_accumulate_lines` for rows held apart): a neighbour
  barrier, the remote stores of the shard's line rows and their block
  ranges to both neighbours, the line sum of its own lines while they fly,
  then the wait and the line sum of the received halos, in one launch.

Both take a :class:`~spectrobot_tpu_torch.parallel.peer.Ring`: on a ring of
ranks a tensor is this rank's block; on the loopback ring a tensor holds
every shard's block along a leading axis, and one launch covers them all.

What bounds them on an H100: the ring, bytes (NVLink's 450 GB/s each way
between cards, 3.35 TB/s of device memory on the loopback); the fused
kernel, FP32 arithmetic on the in-cutoff pairs, as K3, whose loop it runs
(``csrc/line_sum_item.cuh``).  It walks only the line blocks whose center
range, found on the card and sent behind the rows, reaches each tile
(:func:`blocks_visited` counts them on the host), cuts the hull of those
blocks into segments and adds the segments' sums in the last block of
each tile: one launch, and a wrapper that only allocates.

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
    MAX_OUT, arrival_counters, current_stream, split_blocks)
from spectrobot_tpu_torch.ops.opacity import KernelLines, accumulate_plain
from spectrobot_tpu_torch.parallel import peer
from spectrobot_tpu_torch.parallel.collectives import ring_shift
from spectrobot_tpu_torch.parallel.halo import (
    _hops, halo_accumulate_fn, pack_lines, unpack_lines)
from spectrobot_tpu_torch.parallel.peer import (
    CHUNK_FLOATS, MIN_CHUNK_FLOATS, TIMEOUT_S, Ring, ring_chunk)

# Line-sum items a fused call aims at: the blocks take them from a work
# counter, so shorter items (more of them) shorten the launch's tail until
# each item's fixed cost (the tile's bounds, its hull, its partial sums)
# takes over.
HALO_ITEMS = 4096

# Kernel launches made by the wrappers in this process.
RING_LAUNCHES = 0
HALO_LAUNCHES = 0
_LIB = None
# Per (device, stream): the fused kernel's arrival counters, one per
# (shard, tile), and its work counter, zero between calls (each launch
# leaves them zero); and its scratch (the block ranges and the partial
# sums), which only the launch of the call reads and writes.
_COUNTERS: dict = {}
_SCRATCH: dict = {}


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
        f32 = ctypes.c_float
        lib.dma_halo_launch.argtypes = (
            [i32] + [ptr] * 6 + [i64] * 3 + [ptr, i64, i64, ptr, ptr, i64]
            + [i32] * 6 + [f32, i32, u64, f32, i32, ptr])
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


def _check_kernel_tensor(ring: Ring, t: torch.Tensor, name: str,
                         dense: bool = True) -> None:
    """A kernel's tensor lies on the ring's card in float32 (and with
    ``dense``, contiguous)."""
    if (t.is_cuda and t.get_device() == ring.device.index
            and t.dtype is torch.float32 and (t.is_contiguous() or not dense)):
        return
    if t.device.type != "cuda":
        raise ValueError(f"no remote-copy kernel for device {t.device}")
    if t.device != ring.device:
        raise ValueError(f"{name} is on {t.device}, the ring on "
                         f"{ring.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if dense and not t.is_contiguous():
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
    return ring_exchange_hops(ring, x, (direction,))[0]


def _directions(directions) -> tuple:
    """(first direction index, count) of the kernel's directions: (+1,),
    (-1,) or (+1, -1)."""
    directions = tuple(directions)
    for d in directions:
        _direction_index(d)
    if directions not in ((1,), (-1,), (1, -1)):
        raise ValueError(f"the ring kernel moves blocks in the directions "
                         f"(1,), (-1,) or (1, -1), got {directions}")
    return _direction_index(directions[0]), len(directions)


def ring_exchange_hops(ring: Ring, x: torch.Tensor,
                       directions=(1, -1)) -> torch.Tensor:
    """:func:`ring_exchange_cuda` in each of ``directions`` ((+1,), (-1,)
    or (+1, -1)) in one launch: out [len(directions), *x.shape], out[i]
    the blocks moved at ``directions[i]``.  On a ring ``on_device`` the
    launch counts its epoch on the card, so that a CUDA graph may capture
    it: inside a capture the ring must be reserved for the block
    (``Ring.reserve``) beforehand."""
    global RING_LAUNCHES
    d, n_dirs = _directions(directions)
    _check_ring_tensor(ring, x, "x", 2)
    n_floats = x.numel() // ring.n if ring.loopback else x.numel()
    if not x.is_cuda and x.device.type == "cpu":
        ring.begin_call()
        return torch.stack([ring_exchange_plain(ring, x, k)
                            for k in directions])
    _check_kernel_tensor(ring, x, "x")
    if n_floats == 0:
        raise ValueError("the ring exchange takes a non-empty block")
    lib = peer.library()
    if torch.cuda.is_current_stream_capturing():
        if not (ring.on_device and ring.reserved(n_floats)):
            raise RuntimeError(
                "a captured ring exchange needs a ring on the device's epoch "
                "reserved for its block (Ring.reserve) before the capture")
    ring.sync_once("dma_ring")
    args = ring.workspace_for(n_floats).ring_args
    out = torch.empty((n_dirs, *x.shape), dtype=x.dtype, device=x.device)
    args.x, args.out = x.data_ptr(), out.data_ptr()
    args.n, args.d, args.n_dirs = n_floats, d, n_dirs
    args.chunk = ring_chunk(n_floats, args.n_loc * n_dirs)
    args.epoch = 0 if ring.on_device else ring.begin_call()
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


def workspace_floats(n_out: int, L: int) -> int:
    """The receive buffer a fused call needs: the payload (the rows [3 +
    n_out, L], then the center range (min, max) of each of the
    ceil(L / BLOCK_L) line blocks), and a flag for every copy item of a
    row (``CHUNK_FLOATS`` each) and for the ranges (a workspace holds one
    flag per ``MIN_CHUNK_FLOATS``)."""
    n_flags = (3 + n_out) * -(-L // CHUNK_FLOATS) + 1
    payload = (3 + n_out) * L + 2 * -(-L // BLOCK_L)
    return max(payload, n_flags * MIN_CHUNK_FLOATS)


def halo_segments(n_items: int, n_blocks: int) -> int:
    """Segments of each of the fused kernel's ``n_items`` (shard, source,
    tile) items, so that they make about ``HALO_ITEMS`` items in all (at
    most ``n_blocks``: a segment takes a block or more of the item's hull
    of blocks within reach, found on the card)."""
    return split_blocks(n_items, max(n_blocks, 1), HALO_ITEMS)[0]


def _tile_spans(nu: torch.Tensor, cutoff_cm1: Optional[float]) -> tuple:
    """(lo, hi, reach) [..., n_tiles] of the TILE_P-point tiles of ``nu``
    [..., P] in float32, the last tile padded with its last point, as
    ``csrc/line_sum_item.cuh:tile_span`` takes them."""
    nu = nu.to(torch.float32)
    P = nu.shape[-1]
    n_tiles = -(-P // TILE_P)
    pad = nu[..., -1:].expand(*nu.shape[:-1], n_tiles * TILE_P - P)
    tiles = torch.cat([nu, pad], -1).reshape(*nu.shape[:-1], n_tiles,
                                              TILE_P)
    lo, hi = tiles.amin(-1), tiles.amax(-1)
    if cutoff_cm1 is None:
        return lo, hi, torch.full_like(lo, math.inf)
    cut = torch.tensor(cutoff_cm1, dtype=torch.float32)
    eps4 = torch.tensor(4.0 * torch.finfo(torch.float32).eps)
    return lo, hi, cut + eps4 * (cut + torch.maximum(lo.abs(), hi.abs()))


def block_ranges(nu_c: torch.Tensor) -> torch.Tensor:
    """The center range of each BLOCK_L-line block: nu_c [..., L] ->
    [..., ceil(L / BLOCK_L), 2], (min, max) over the block's lines (those
    at or past L left out), as the fused kernel's range items find it."""
    L = nu_c.shape[-1]
    nb = -(-L // BLOCK_L)

    def blocks(fill):
        return torch.nn.functional.pad(nu_c.to(torch.float32),
                                       (0, nb * BLOCK_L - L), value=fill
                                       ).reshape(*nu_c.shape[:-1], nb,
                                                 BLOCK_L)

    return torch.stack([blocks(math.inf).amin(-1),
                        blocks(-math.inf).amax(-1)], -1)


def blocks_in_reach(nu: torch.Tensor, packed: torch.Tensor,
                    cutoff_cm1: Optional[float]) -> torch.Tensor:
    """The fused kernel's window rule on the host, for the loopback ring
    of ``n`` shards: nu [n, P_loc] and packed [n, 3 + n_out, L] -> bool
    [n, n_src, n_tiles, n_blocks], whether block b of source s (0 the own
    lines, then each hop's: the left neighbour's, the right one's) has a
    center range that can reach tile t of shard k: the rounded gap
    max(min - hi, lo - max, 0) not beyond the reach, the cutoff plus 4
    ulps of cutoff + |nu| (in float32; the card may fuse the reach's
    product, a last-bit difference).  Every pair of a block left out lies
    beyond the cutoff; with ``cutoff_cm1=None`` every block is in."""
    n = nu.shape[0]
    rg = block_ranges(packed[:, 0])                      # [n, nb, 2]
    rgs = [rg] + [torch.roll(rg, shift, 0) for shift, _ in _hops(n)]
    lo, hi, reach = _tile_spans(nu, cutoff_cm1)          # [n, n_tiles]
    out = []
    for r in rgs:
        gap = torch.maximum(torch.maximum(
            r[:, None, :, 0] - hi[:, :, None],
            lo[:, :, None] - r[:, None, :, 1]), torch.zeros(()))
        out.append(~(gap > reach[:, :, None]))
    return torch.stack(out, 1)


def blocks_visited(nu: torch.Tensor, packed: torch.Tensor,
                   cutoff_cm1: Optional[float]) -> tuple:
    """(blocks the fused kernel stages, block visits of a walk over every
    block) of a loopback call (:func:`blocks_in_reach`)."""
    within = blocks_in_reach(nu, packed, cutoff_cm1)
    return int(within.sum()), within.numel()


def _scratch(dev: torch.device, stream: int, n: int) -> int:
    """The address of at least ``n`` floats of the fused kernel's scratch
    for launches on ``stream`` (kept in ``_SCRATCH``, grown on demand)."""
    have = _SCRATCH.get((dev, stream))
    if have is None or have.numel() < n:
        have = _SCRATCH[dev, stream] = torch.empty(
            max(n, 1 << 16), dtype=torch.float32, device=dev)
    return have.data_ptr()


def _launch_fused(ring: Ring, nu: torch.Tensor, rows: tuple, strides: tuple,
                  n_out: int, L: int, out: torch.Tensor, out_strides: tuple,
                  cutoff_cm1: Optional[float]) -> None:
    """One launch of the fused kernel: the shards' grids ``nu`` [n_loc,
    P], their rows at the pointers ``rows`` (nu_c, scale_x, y, amps) with
    ``strides`` in floats (between the shards' nu_c, scale_x and y;
    between their amps; between the rows of a shard's amps) into ``out``
    with ``out_strides`` (between shards, between rows)."""
    global HALO_LAUNCHES
    if ring.on_device:
        raise ValueError("the fused halo kernel takes its epoch from the "
                         "host: it does not run on a ring on the device's "
                         "epoch")
    lib = _library()
    ring.sync_once("dma_halo")
    ws = ring.workspace_for(workspace_floats(n_out, L))
    epoch = ring.begin_call()
    dev = nu.device
    n_loc, P = ring.local_shards, nu.shape[-1]
    n_dirs = len(ring.directions)
    n_tiles = -(-P // TILE_P)
    nb = -(-L // BLOCK_L)
    n_seg = halo_segments(n_loc * (1 + n_dirs) * n_tiles, nb)
    n_parts = (1 + n_dirs) * n_seg
    parts = n_parts * n_out * n_tiles * TILE_P if n_parts > 1 else 0
    stream = current_stream(dev.index)
    scratch = _scratch(dev, stream, n_loc * (2 * nb + parts))
    counters = arrival_counters(_COUNTERS, dev, stream,
                                n_loc * n_tiles + 1).data_ptr()
    cut = math.inf if cutoff_cm1 is None else float(cutoff_cm1)
    rc = lib.dma_halo_launch(
        dev.index, ws.table.data_ptr(), nu.data_ptr(), *rows, *strides,
        out.data_ptr(), *out_strides, scratch, counters,
        ws.cap_floats, n_loc, n_out, P, L, n_dirs, n_seg, cut, CHUNK_FLOATS,
        epoch, TIMEOUT_S, int(ring.loopback), stream)
    HALO_LAUNCHES += 1
    _raise_on(lib, "dma_halo", rc)


def _check_n_out(n_out: int) -> None:
    if n_out > MAX_OUT:
        raise ValueError(f"the kernel takes 1 to {MAX_OUT} amplitude rows, "
                         f"got {n_out}")


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
    _check_ring_tensor(ring, nu, "nu", 1)
    _check_ring_tensor(ring, packed, "packed", 2)
    q, L, P = packed.shape[-2], packed.shape[-1], nu.shape[-1]
    n_out = q - 3
    if n_out < 1:
        raise ValueError(f"packed rows are [3 + n_out, L], got "
                         f"{tuple(packed.shape)}")
    if packed.device != nu.device:
        raise ValueError(f"packed is on {packed.device}, nu on {nu.device}")
    if nu.device.type == "cpu":
        ring.begin_call()
        return fused_halo_accumulate_plain(ring, nu, packed,
                                           cutoff_cm1=cutoff_cm1)
    for name, t in (("nu", nu), ("packed", packed)):
        _check_kernel_tensor(ring, t, name)
    _check_n_out(n_out)
    lead = (ring.n,) if ring.loopback else ()
    out = torch.empty(lead + (n_out, P), dtype=torch.float32,
                      device=nu.device)
    base, q_L = packed.data_ptr(), q * L
    _launch_fused(ring, nu, tuple(base + 4 * r * L for r in range(4)),
                  (q_L, q_L, L), n_out, L, out, (n_out * P, P), cutoff_cm1)
    return out


def fused_halo_accumulate_lines(ring: Ring, nu: torch.Tensor,
                                lines: KernelLines, *,
                                cutoff_cm1: Optional[float] = 25.0
                                ) -> torch.Tensor:
    """:func:`fused_halo_accumulate_cuda` on lines held as separate rows
    (``lines.nu_c``, ``scale_x``, ``y`` [L] and ``amps`` [n_out, L] per
    shard, ``amps`` of any strides but a unit one along the lines, as
    ``parallel.halo.partition_kernel_lines`` gives them; ``chi_b``
    unused), with the shards' sums laid out as the grid's:
    on the loopback nu [n, P_loc] -> [n_out, n P_loc], on a ring of ranks
    nu [P_loc] -> [n_out, P_loc].  On the card the kernel reads the rows and
    writes the result where they are (no packing, no layout pass); on the
    CPU the rows are packed (``parallel.halo.pack_lines``) for the plain
    version."""
    rows = tuple(lines[:4])
    lead = (ring.n,) if ring.loopback else ()
    L, P = rows[0].shape[-1], nu.shape[-1]
    n_out = rows[3].shape[-2] if rows[3].dim() == len(lead) + 2 else 0
    for name, t in zip(("nu",) + KernelLines._fields[:4], (nu,) + rows):
        want = lead + ((P,) if name == "nu" else (n_out, L)
                       if name == "amps" else (L,))
        if t.shape != want or t.device != nu.device:
            raise ValueError(f"{name} must be {want} on {nu.device} on this "
                             f"ring, got {tuple(t.shape)} on {t.device}")
    if n_out < 1:
        raise ValueError(f"amps must be [..., n_out, L], got "
                         f"{tuple(rows[3].shape)}")
    if nu.device.type == "cpu":
        packed = pack_lines(KernelLines(*rows)).to(nu.dtype)
        out = fused_halo_accumulate_cuda(ring, nu, packed,
                                         cutoff_cm1=cutoff_cm1)
        return (out.transpose(0, 1).reshape(n_out, -1) if ring.loopback
                else out)
    for name, t in zip(("nu",) + KernelLines._fields[:4], (nu,) + rows):
        _check_kernel_tensor(ring, t, name, dense=name != "amps")
    amps = rows[3]
    if amps.stride(-1) != 1 and L > 1:
        raise ValueError(f"amps must be laid out along its lines, got "
                         f"strides {amps.stride()}")
    _check_n_out(n_out)
    n_loc = ring.local_shards
    out = torch.empty((n_out, n_loc * P), dtype=torch.float32,
                      device=nu.device)
    amp_shard = amps.stride(0) if ring.loopback else 0
    _launch_fused(ring, nu, tuple(t.data_ptr() for t in rows),
                  (L, amp_shard, amps.stride(-2)), n_out, L, out,
                  (P, n_loc * P), cutoff_cm1)
    return out
