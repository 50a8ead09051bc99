"""Single-state basis contraction on the card: the wrapper of the
hand-written CUDA kernel ``csrc/basis_single.cu`` (K4) and its plain
PyTorch version.

The kernel replaces the TPU kernel
``spectrobot_tpu/ops/pallas_opacity.py:_basis_kernel`` (K4), reached there
through ``basis_contract_pallas_jit`` by the forward-mode derivatives of the
single-state line sum (``make_accumulate_op`` at one state):

    out[r, p] = sum_i C1[r,i] K + C2[r,i] Kx + C3[r,i] xKx + C4[r,i] Ky

with the basis {K, dK/dx, x dK/dx, dK/dy} of Humlicek's w4 (times chi and
the cutoff mask) at every (point p, line i) pair of the one state.  Under
``torch.func.jacfwd`` the rows carry every Jacobian column, so the basis is
evaluated once per Jacobian.

What bounds it on an H100: as K2 (whose thread block it runs,
``csrc/basis_contract.cuh``: the basis once per pair on the CUDA cores,
straight into 3xTF32 ``mma.sync`` products on the tensor cores, every
row's sums in registers).  One state gives K2's grid only P/128 blocks, so
K4 takes K3's grid (tile, line segment; ``ops.cuda_single.segments``) and
adds the segments' [R, P] partial sums in a fixed order in a second pass:
deterministic, no atomics.  More rows than the registers hold
(``MAX_ROWS``) are split into row groups, each of which evaluates the
basis anew.

Device rule: a CPU tensor goes to :func:`basis_contract_single_plain`; a
CUDA tensor always launches the kernel, and a build or launch failure
raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from spectrobot_tpu_torch.kernels import launch
from spectrobot_tpu_torch.ops.cuda_opacity import (
    BLOCK_L, SUB_L, TILE_P, Windows, _round_up, check_tensors, check_windows,
    pad_lines)
from spectrobot_tpu_torch.ops.cuda_single import segments
from spectrobot_tpu_torch.ops.opacity import _basis

# The most coefficient rows one thread block holds in registers
# (csrc/basis_contract.cuh MAX_ROWS, K2's limit; checked against the
# library when it is loaded).
# A call takes any number: its rows are split into groups of at most this.
MAX_ROWS = 223

# The kernel, bound at its first launch (``kernels.launch``).
_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = launch.Kernel(
    "basis_single", [_ptr] * 13 + [_i32] * 6 + [ctypes.c_float, _ptr],
    {"basis_single_tile_p": TILE_P, "basis_single_block_l": BLOCK_L,
     "basis_single_sub_l": SUB_L, "basis_single_max_rows": MAX_ROWS})


def basis_contract_single_plain(nu_grid, nu_c, sx, y, C1, C2, C3, C4, *,
                                cutoff_cm1: Optional[float] = 25.0,
                                chi_b: Optional[torch.Tensor] = None,
                                chunk: int = 256,
                                variant: str = "humlicek4") -> torch.Tensor:
    """The plain PyTorch version of :func:`basis_contract_single`, any dtype
    and device: nu_c/sx/y [L], C1..C4 [R, L], chi_b [L] or None -> [R, P]
    in ``nu_grid``'s dtype.  Every line is evaluated at every point
    (pointwise gradient of the ``variant`` evaluator, cutoff mask) in
    ``chunk``-line slabs and contracted with ``torch.matmul``."""
    dt = nu_grid.dtype
    L = nu_c.shape[0]
    out = torch.zeros((C1.shape[0],) + nu_grid.shape, dtype=dt,
                      device=nu_grid.device)
    for lo in range(0, L, chunk):
        sl = slice(lo, lo + chunk)
        basis = _basis(nu_grid, nu_c[sl].to(dt), sx[sl].to(dt), y[sl].to(dt),
                       None if chi_b is None else chi_b[sl].to(dt),
                       cutoff_cm1=cutoff_cm1, variant=variant)
        for C, b in zip((C1, C2, C3, C4), basis):
            out += torch.matmul(C[:, sl].to(dt), b)
    return out


def row_groups(R: int) -> tuple:
    """(n_grp, G): how K4 splits R rows into groups of at most
    ``MAX_ROWS``, as even as the count allows."""
    n_grp = -(-R // MAX_ROWS)
    return n_grp, -(-R // n_grp)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on a 16-byte
    boundary (K2 and K4 copy coefficient rows 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(nu_grid, nu_c, sx, y, C, chi_b, *, kernel: bool) -> None:
    """Raise on inputs of the wrong shape or on mixed devices; with
    ``kernel``, also on what the kernel does not take (a dtype other than
    float32, non-contiguous tensors, no rows)."""
    if nu_grid.dim() != 1:
        raise ValueError(f"nu_grid must be 1-D, got {tuple(nu_grid.shape)}")
    if nu_c.dim() != 1 or C[0].dim() != 2:
        raise ValueError(f"one state: nu_c must be [L] and C1 [R, L], got "
                         f"{tuple(nu_c.shape)} and {tuple(C[0].shape)}")
    L, R = nu_c.shape[0], C[0].shape[0]
    if kernel and R == 0:
        raise ValueError("the basis kernel needs at least one row")
    want = {"nu_c": (nu_c, (L,)), "sx": (sx, (L,)), "y": (y, (L,))}
    for k, c in enumerate(C, 1):
        want[f"C{k}"] = (c, (R, L))
    if chi_b is not None:
        want["chi_b"] = (chi_b, (L,))
    want["nu_grid"] = (nu_grid, tuple(nu_grid.shape))
    check_tensors(nu_grid, want, kernel=kernel)


def basis_contract_single(nu_grid: torch.Tensor, windows: Windows,
                          nu_c: torch.Tensor, sx: torch.Tensor,
                          y: torch.Tensor, C1: torch.Tensor, C2: torch.Tensor,
                          C3: torch.Tensor, C4: torch.Tensor, *,
                          cutoff_cm1: Optional[float] = 25.0,
                          chi_b: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Single-state basis contraction (counterpart of the reference's
    ``basis_contract_pallas_jit``): nu_grid [P] (offset coordinates),
    nu_c/sx/y [L] with ascending centers, C1..C4 [R, L] (any R), chi_b [L]
    or None, all on one device -> [R, P].  ``cutoff_cm1=None`` sums every
    line at every point.  CUDA tensors must be float32; CPU tensors go to
    :func:`basis_contract_single_plain` in any dtype.

    ``windows``: the ``cuda_opacity.Windows`` of this grid and these
    centers (``line_windows``), as K3 takes them (the plain version needs
    none).
    """
    C = (C1, C2, C3, C4)
    on_cpu = nu_grid.device.type == "cpu"
    _check(nu_grid, nu_c, sx, y, C, chi_b, kernel=not on_cpu)
    if on_cpu:
        return basis_contract_single_plain(nu_grid, nu_c, sx, y, *C,
                                           cutoff_cm1=cutoff_cm1, chi_b=chi_b)
    if nu_grid.device.type != "cuda":
        raise ValueError(f"no basis kernel for device {nu_grid.device}")
    L, R, P = nu_c.shape[0], C1.shape[0], nu_grid.shape[0]
    check_windows(nu_grid, windows, L, cutoff_cm1)
    win = windows
    dev = nu_grid.device
    Pp, Lp = win.nu_pad.shape[0], _round_up(max(L, BLOCK_L), BLOCK_L)
    nuc_d = pad_lines(nu_c, Lp, win.far)
    sx_d, y_d = pad_lines(sx, Lp, 1e6), pad_lines(y, Lp, 1e6)
    chi_d = None if chi_b is None else pad_lines(chi_b, Lp, 0.0)
    C_d = [aligned(pad_lines(c, Lp, 0.0)) for c in C]
    n_seg, seg_blocks = segments(win)
    _, G = row_groups(R)
    part = (None if n_seg == 1 else
            torch.empty((n_seg, R, Pp), dtype=torch.float32, device=dev))
    out = torch.empty((R, Pp), dtype=torch.float32, device=dev)
    cut = math.inf if cutoff_cm1 is None else float(cutoff_cm1)
    with torch.cuda.device(dev):
        KERNEL(win.nu_pad.data_ptr(), nuc_d.data_ptr(), sx_d.data_ptr(),
               y_d.data_ptr(), None if chi_d is None else chi_d.data_ptr(),
               *(c.data_ptr() for c in C_d), win.starts.data_ptr(),
               win.counts.data_ptr(),
               None if part is None else part.data_ptr(), out.data_ptr(), R,
               G, Pp, Lp, n_seg, seg_blocks, cut, launch.stream(dev.index))
    return out[:, :P]
