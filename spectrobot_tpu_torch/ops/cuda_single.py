"""Single-state opacity line sum on the card: the wrapper of the hand-written
CUDA kernel ``csrc/opacity_single.cu`` (K3) and its plain PyTorch version.

The kernel replaces the TPU kernel
``spectrobot_tpu/ops/pallas_opacity.py:_kernel`` (K3), reached there through
``_accumulate_padded`` by the nu-mesh's halo accumulation
(``parallel/halo.py:halo_accumulate_pallas_fn``) and by ``accumulate_pallas``
(the dense bench):

    out[o, p] = sum_i amps[o, i] * Re w(x_ip, y_i) * chi * [|dnu| <= cut]

for one state and ``n_out`` amplitude rows (1 to ``MAX_OUT``).

What bounds it on an H100: FP32 arithmetic on the CUDA cores, as K1 (whose
per-pair code and tier decision it shares, ``csrc/voigt_primal.cuh``).  One
state gives one block per 128-point tile only a fraction of the card, so
each tile's window of line blocks is cut into segments, one thread block
each, and a second pass adds the segments' partial sums in a fixed order:
deterministic, no atomics.

Device rule: a CPU tensor goes to :func:`accumulate_single_plain`; a CUDA
tensor always launches the kernel, and a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from spectrobot_tpu_torch.ops.cuda_opacity import (
    BLOCK_L, TILE_P, Windows, _round_up, check_tensors, check_windows,
    pad_lines)
from spectrobot_tpu_torch.ops.opacity import KernelLines, accumulate_plain

# The most amplitude rows one call takes (csrc/opacity_single.cu MAX_OUT,
# checked against the library when it is loaded).
MAX_OUT = 8
# Thread blocks a call aims at: about 16 resident 128-thread blocks on each
# of the H100's 132 SMs.  The segment length follows from it and the
# window table (the longest tile window over the number of segments).
TARGET_BLOCKS = 2048

# Kernel launches made by accumulate_single in this process.
LAUNCHES = 0
_LIB = None


def accumulate_single_plain(nu_grid, nu_c, scale_x, y, amps, *,
                            cutoff_cm1: Optional[float] = 25.0,
                            chi_b: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The plain PyTorch version of :func:`accumulate_single`, any dtype and
    device: lines [L], amps [n_out, L] -> [n_out, P] in ``nu_grid``'s dtype
    (``ops.opacity.accumulate_plain`` on one state; every line at every
    point, so no window table)."""
    return accumulate_plain(nu_grid, KernelLines(nu_c, scale_x, y, amps,
                                                 chi_b),
                            cutoff_cm1=cutoff_cm1)


def split_blocks(n_items: int, n_blocks: int,
                 target: int = TARGET_BLOCKS) -> tuple:
    """(n_seg, seg_blocks): a window of ``n_blocks`` blocks (line blocks,
    or tiles for K5) cut into segments of ``seg_blocks`` each, so that
    ``n_items`` items of ``n_seg`` segments make about ``target`` thread
    blocks."""
    n_seg = max(1, min(n_blocks, -(-target // n_items)))
    seg_blocks = -(-n_blocks // n_seg)
    return -(-n_blocks // seg_blocks), seg_blocks


def segments(windows: Windows) -> tuple:
    """(n_seg, seg_blocks): how K3 cuts each tile's window of line blocks
    so that about ``TARGET_BLOCKS`` thread blocks share the work."""
    return split_blocks(windows.nu_pad.shape[0] // TILE_P,
                        windows.max_blocks)


def _check(nu_grid, nu_c, scale_x, y, amps, chi_b, *, kernel: bool) -> None:
    """Raise on inputs of the wrong shape or on mixed devices; with
    ``kernel``, also on anything else the kernel does not take (more than
    ``MAX_OUT`` rows, a dtype other than float32, non-contiguous tensors)."""
    if nu_grid.dim() != 1:
        raise ValueError(f"nu_grid must be 1-D, got {tuple(nu_grid.shape)}")
    if nu_c.dim() != 1 or amps.dim() != 2:
        raise ValueError(f"one state: nu_c must be [L] and amps [n_out, L], "
                         f"got {tuple(nu_c.shape)} and {tuple(amps.shape)}")
    L, n_out = nu_c.shape[0], amps.shape[0]
    if kernel and not 1 <= n_out <= MAX_OUT:
        raise ValueError(f"the kernel takes 1 to {MAX_OUT} amplitude rows, "
                         f"got {n_out}")
    want = {"nu_c": (nu_c, (L,)), "scale_x": (scale_x, (L,)),
            "y": (y, (L,)), "amps": (amps, (n_out, L))}
    if chi_b is not None:
        want["chi_b"] = (chi_b, (L,))
    want["nu_grid"] = (nu_grid, tuple(nu_grid.shape))
    check_tensors(nu_grid, want, kernel=kernel)


def _library() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        from spectrobot_tpu_torch.kernels import build

        lib = build.load("opacity_single")
        geometry = (lib.opacity_single_tile_p(), lib.opacity_single_block_l(),
                    lib.opacity_single_max_out())
        if geometry != (TILE_P, BLOCK_L, MAX_OUT):
            raise RuntimeError(f"kernel geometry {geometry} != wrapper "
                               f"{(TILE_P, BLOCK_L, MAX_OUT)}")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.opacity_single_launch.argtypes = [ptr] * 10 + [
            i32, i32, i32, i32, i32, ctypes.c_float, ptr]
        lib.opacity_single_launch.restype = i32
        lib.opacity_single_error_string.argtypes = [i32]
        lib.opacity_single_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def accumulate_single(nu_grid: torch.Tensor, windows: Windows,
                      nu_c: torch.Tensor, scale_x: torch.Tensor,
                      y: torch.Tensor, amps: torch.Tensor, *,
                      cutoff_cm1: Optional[float] = 25.0,
                      chi_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-state line sum (counterpart of the reference's
    ``accumulate_pallas``): nu_grid [P], nu_c/scale_x/y [L] with ascending
    centers, amps [n_out, L], chi_b [L] or None, all on one device ->
    [n_out, P].  ``cutoff_cm1=None`` sums every line at every point.  CUDA
    tensors must be float32 with 1 <= n_out <= ``MAX_OUT``; CPU tensors go
    to :func:`accumulate_single_plain` in any dtype.

    ``windows``: the :class:`~spectrobot_tpu_torch.ops.cuda_opacity.Windows`
    of this grid and these centers (``line_windows``, widened by its shift
    margin; the per-pair cutoff mask keeps the result exact).  The plain
    version needs none.
    """
    global LAUNCHES
    on_cpu = nu_grid.device.type == "cpu"
    _check(nu_grid, nu_c, scale_x, y, amps, chi_b, kernel=not on_cpu)
    if on_cpu:
        return accumulate_single_plain(nu_grid, nu_c, scale_x, y, amps,
                                       cutoff_cm1=cutoff_cm1, chi_b=chi_b)
    if nu_grid.device.type != "cuda":
        raise ValueError(f"no opacity kernel for device {nu_grid.device}")
    L, n_out, P = nu_c.shape[0], amps.shape[0], nu_grid.shape[0]
    check_windows(nu_grid, windows, L, cutoff_cm1)
    win = windows
    lib = _library()

    dev = nu_grid.device
    Pp, Lp = win.nu_pad.shape[0], _round_up(max(L, BLOCK_L), BLOCK_L)
    nuc_d = pad_lines(nu_c, Lp, win.far)
    sx_d, y_d = pad_lines(scale_x, Lp, 1e6), pad_lines(y, Lp, 1e6)
    chi_d = None if chi_b is None else pad_lines(chi_b, Lp, 0.0)
    amps_d = pad_lines(amps, Lp, 0.0)
    n_seg, seg_blocks = segments(win)
    part = (None if n_seg == 1 else
            torch.empty((n_seg, n_out, Pp), dtype=torch.float32, device=dev))
    out = torch.empty((n_out, Pp), dtype=torch.float32, device=dev)
    cut = math.inf if cutoff_cm1 is None else float(cutoff_cm1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.opacity_single_launch(
            win.nu_pad.data_ptr(), nuc_d.data_ptr(), sx_d.data_ptr(),
            y_d.data_ptr(), None if chi_d is None else chi_d.data_ptr(),
            amps_d.data_ptr(), win.starts.data_ptr(), win.counts.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr(),
            n_out, Pp, Lp, n_seg, seg_blocks, cut, stream)
        LAUNCHES += 1
    if rc != 0:
        msg = lib.opacity_single_error_string(rc).decode()
        raise RuntimeError(f"opacity_single kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    return out[:, :P]
