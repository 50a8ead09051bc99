"""Batched transposed basis contraction on the card: the wrapper of the
hand-written CUDA kernel ``csrc/basis_transpose.cu`` and its plain PyTorch
version.

The kernel replaces the TPU kernel
``spectrobot_tpu/ops/pallas_opacity.py:_basis_transpose_kernel`` (K5),
reached there through ``basis_transpose_pallas_jit`` by every reverse-mode
gradient of the line sum (``analytic_jvp='rev'``):

    Ab_k[b, r, i] = sum_p ct[b, r, p] basis_k(p, i),   k in {K, Kx, xKx, Ky}

with the basis of Humlicek's w4 (times chi and the cutoff mask) at every
(point p, line i) pair of state b: the adjoint of K2
(``ops/cuda_basis.py``).  ``ops.opacity.transpose_epilogue`` turns the four
projections into the cotangents of the line inputs.

What bounds it on an H100: FP32 work on the CUDA cores, the basis (about
2.5x the forward's Voigt flops per pair) and 4 FMAs per cotangent row per
pair; the bytes (the cotangent rows read once per visited tile, the
outputs written once) are small beside it.  The design (see the source):
one block per (128-line block, state, segment of the tile window, chunk of
rows), one line per thread, the block walking its segment with the tile's
rows staged in shared memory; each line's sums in registers, in fp32 and
in point order (all of them at R <= 2, 8 rows a block above); a warp skips
the tiles beyond the cutoff of its lines and the block those whose rows
are all zero; the segments' partial sums are added in a fixed order by the
last block to finish.  Deterministic, no atomics on values, no TF32.  The
kernel reads the unpadded rows: the wrapper allocates the outputs (and the
partial sums' workspace) and launches it, nothing else.

Device rule: a CPU tensor goes to :func:`basis_transpose_batch_plain`; a
CUDA tensor always launches the kernel, and a build or launch failure
raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from spectrobot_tpu_torch.kernels import launch
from spectrobot_tpu_torch.ops.cuda_opacity import (
    BLOCK_L, SUB_L, TILE_P, _PLAIN_SLAB, Windows, check_windows)
from spectrobot_tpu_torch.ops.cuda_single import split_blocks
from spectrobot_tpu_torch.ops.opacity import tangent_transpose_plain

# The most cotangent rows one kernel call takes (csrc/basis_transpose.cu
# MAX_ROWS, checked against the library when it is loaded); a thread block
# holds the sums of REG_ROWS rows at R <= REG_ROWS, else of CHUNK_ROWS, in
# registers.
MAX_ROWS = 89
REG_ROWS = 2
CHUNK_ROWS = 8

# Thread blocks a call aims at: about four waves of the 8 blocks of 128
# threads an SM holds at R <= 2 (64 registers a thread) on the H100's 132
# SMs, so that the segments' uneven work (a tile at a line's center costs
# many times one in its wing) evens out.
TARGET_BLOCKS = 4096

# The kernel, bound at its first launch (``kernels.launch``).
_ptr, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = launch.Kernel(
    "basis_transpose", [_ptr] * 14 + [_i32] * 8 + [_f32, _f32, _ptr],
    {"basis_transpose_tile_p": TILE_P, "basis_transpose_block_l": BLOCK_L,
     "basis_transpose_sub_l": SUB_L, "basis_transpose_reg_rows": REG_ROWS,
     "basis_transpose_chunk_rows": CHUNK_ROWS,
     "basis_transpose_max_rows": MAX_ROWS})

Projections = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def basis_transpose_batch_plain(nu_grid, nu_c, sx, y, ct, *,
                                cutoff_cm1: Optional[float] = 25.0,
                                chi_b: Optional[torch.Tensor] = None,
                                variant: str = "humlicek4") -> Projections:
    """The plain PyTorch version of :func:`basis_transpose_batch`, any dtype
    and device: nu_c/sx/y [B, L], ct [B, R, P], chi_b [B, L] or None ->
    (AbK, AbKx, AbxKx, AbKy), each [B, R, L] in ``nu_grid``'s dtype.

    Every line is evaluated at every point (pointwise gradient of the
    ``variant`` evaluator, cutoff mask) and projected with
    ``torch.matmul``.  States are taken in groups
    so that one (state, line, point) slab holds at most ``_PLAIN_SLAB``
    elements."""
    B, L = nu_c.shape
    chunk = min(max(L, 1), 256)
    group = max(1, _PLAIN_SLAB // (chunk * max(nu_grid.shape[0], 1)))
    parts = [tangent_transpose_plain(
                 nu_grid, nu_c[g], sx[g], y[g], ct[g],
                 None if chi_b is None else chi_b[g], chunk=chunk,
                 cutoff_cm1=cutoff_cm1, variant=variant)
             for g in (slice(b0, b0 + group) for b0 in range(0, B, group))]
    return tuple(torch.cat(o) for o in zip(*parts))


def row_chunks(n_rows: int) -> int:
    """The thread blocks the kernel gives each (line block, state, segment)
    for ``n_rows`` cotangent rows: one at R <= REG_ROWS, else one per
    CHUNK_ROWS rows."""
    return 1 if n_rows <= REG_ROWS else -(-n_rows // CHUNK_ROWS)


def segments(windows: Windows, n_states: int, n_rows: int = 2) -> tuple:
    """(n_seg, seg_tiles): how the kernel cuts each line block's window of
    tiles so that the (line block, state, segment, row chunk) grid makes
    about ``TARGET_BLOCKS`` thread blocks; every window fits in n_seg
    segments of seg_tiles tiles."""
    return split_blocks(windows.starts_T.shape[0] * max(n_states, 1)
                        * row_chunks(n_rows), windows.max_tiles,
                        TARGET_BLOCKS)


def _check(nu_grid, nu_c, sx, y, ct, chi_b, *, kernel: bool) -> None:
    """Raise on inputs of the wrong shape or on mixed devices; with
    ``kernel``, also on what the kernel does not take (more states or rows
    than it has room for, a dtype other than float32)."""
    if nu_grid.dim() != 1:
        raise ValueError(f"nu_grid must be 1-D, got {tuple(nu_grid.shape)}")
    if nu_c.dim() != 2 or ct.dim() != 3:
        raise ValueError(f"nu_c must be [B, L] and ct [B, R, P], got "
                         f"{tuple(nu_c.shape)} and {tuple(ct.shape)}")
    B, L = nu_c.shape
    R = ct.shape[1]
    if kernel:
        if B > 65535:
            raise ValueError(f"at most 65535 states per call, got {B}")
        if R > MAX_ROWS:
            raise ValueError(
                f"{R} cotangent rows, but the transpose kernel takes at most "
                f"{MAX_ROWS} a call; ops.opacity.BasisTranspose splits a "
                f"folded jacrev batch into calls of at most {MAX_ROWS} rows")
    want = {"nu_c": (nu_c, (B, L)), "sx": (sx, (B, L)), "y": (y, (B, L)),
            "ct": (ct, (B, R, nu_grid.shape[0]))}
    if chi_b is not None:
        want["chi_b"] = (chi_b, (B, L))
    want["nu_grid"] = (nu_grid, tuple(nu_grid.shape))
    for name, (t, shape) in want.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != nu_grid.device:
            raise ValueError(f"{name} is on {t.device}, nu_grid on "
                             f"{nu_grid.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if kernel and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def basis_transpose_batch(nu_grid: torch.Tensor, windows: Windows,
                          nu_c: torch.Tensor, sx: torch.Tensor,
                          y: torch.Tensor, ct: torch.Tensor, *,
                          cutoff_cm1: Optional[float] = 25.0,
                          chi_b: Optional[torch.Tensor] = None
                          ) -> Projections:
    """Batched transposed basis contraction (counterpart of the reference's
    ``basis_transpose_pallas_jit``, batched over states): nu_grid [P]
    (offset coordinates), nu_c/sx/y [B, L], ct [B, R, P], chi_b [B, L] or
    None, all on one device -> (AbK, AbKx, AbxKx, AbKy), each [B, R, L].
    CUDA tensors must be float32; CPU tensors go to
    :func:`basis_transpose_batch_plain` in any dtype.

    ``windows``: the scene's ``cuda_opacity.Windows`` (its per-line-block
    tile windows; the plain version needs none).  The kernel skips states
    whose cotangent rows are all zero; a zero-amplitude state is not
    skipped, since its amplitude cotangent is not zero.
    """
    on_cpu = nu_grid.device.type == "cpu"
    _check(nu_grid, nu_c, sx, y, ct, chi_b, kernel=not on_cpu)
    if on_cpu:
        return basis_transpose_batch_plain(nu_grid, nu_c, sx, y, ct,
                                           cutoff_cm1=cutoff_cm1, chi_b=chi_b)
    if nu_grid.device.type != "cuda":
        raise ValueError(f"no transpose kernel for device {nu_grid.device}")
    B, L = nu_c.shape
    R, P = ct.shape[1], nu_grid.shape[0]
    check_windows(nu_grid, windows, L, cutoff_cm1)
    win = windows
    dev = nu_grid.device
    n_lblk = win.starts_T.shape[0]
    n_seg, seg_tiles = segments(win, B, R)
    nu_c, sx, y, ct = (a.contiguous() for a in (nu_c, sx, y, ct))
    chi_b = None if chi_b is None else chi_b.contiguous()
    outs = [torch.empty((B, R, L), dtype=torch.float32, device=dev)
            for _ in range(4)]
    part = (None if n_seg == 1 else torch.empty(
        (n_seg, B, 4 * R, n_lblk * BLOCK_L), dtype=torch.float32, device=dev))
    cut = math.inf if cutoff_cm1 is None else float(cutoff_cm1)
    with torch.cuda.device(dev):
        stream = launch.stream(dev.index)
        counters = (None if n_seg == 1 else
                    launch.arrival_counters("basis_transpose", dev, stream,
                                            B * n_lblk * row_chunks(R)))
        KERNEL(win.nu_pad.data_ptr(), nu_c.data_ptr(), sx.data_ptr(),
               y.data_ptr(), None if chi_b is None else chi_b.data_ptr(),
               ct.data_ptr(), win.starts_T.data_ptr(), win.counts_T.data_ptr(),
               None if part is None else part.data_ptr(),
               None if counters is None else counters.data_ptr(),
               *(o.data_ptr() for o in outs), B, R, P, win.nu_pad.shape[0], L,
               n_lblk, n_seg, seg_tiles, win.far, cut, stream)
    return tuple(outs)
