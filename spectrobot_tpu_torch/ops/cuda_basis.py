"""Batched basis contraction on the card: the wrapper of the hand-written
CUDA kernel ``csrc/basis_batch.cu``, its plain PyTorch version, and the
three engines of the differentiable line sum (K1, K2, K5, K3 and K4; their
plain versions; their plain versions with the Weideman evaluator).

The kernel replaces the TPU kernel
``spectrobot_tpu/ops/pallas_opacity.py:_basis_batch_kernel`` (K2), reached
there through ``basis_contract_pallas_batch_jit`` by every forward-mode
Jacobian:

    out[b, r, p] = sum_i C1[b,r,i] K + C2[b,r,i] Kx + C3[b,r,i] xKx
                 + C4[b,r,i] Ky

with the basis {K, dK/dx, x dK/dx, dK/dy} of Humlicek's w4 (times chi and
the cutoff mask) at every (point p, line i) pair of state b.  The rows r
carry every Jacobian column, so the basis is evaluated once per Jacobian
up to ``MAX_ROWS`` rows (111 columns); past that the rows go in row groups
of at most ``MAX_ROWS``, as even as the count allows, one launch and one
evaluation of the basis a group (:func:`basis_contract_batch`), as the
reference's kernel takes any R.

What bounds it on an H100: the basis on the CUDA cores (FP32, about 2.5x
the forward's Voigt flops per pair), the contraction on the tensor cores
(4 FMAs per row per pair, 264 at R = 66, in three TF32 passes) and the
[B, R, P] output written once.  The design (see ``csrc/basis_contract.cuh``)
evaluates each pair's basis once, straight into the A fragments of
3xTF32 ``mma.sync`` products (hi/lo split, lo.lo dropped: the counterpart
of the reference's 3-pass HIGH matrix-unit precision), stages the rows by
``cp.async`` and keeps every row's sums in registers: deterministic, no
atomics.

Device rule: a CPU tensor goes to :func:`basis_contract_batch_plain`; a
CUDA tensor always launches the kernel, and a build or launch failure
raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from spectrobot_tpu_torch.ops.cuda_opacity import (
    BLOCK_L, SUB_L, TILE_P, _PLAIN_SLAB, Windows, _round_up,
    accumulate_batch, accumulate_batch_plain, check_windows, pad_lines)
from spectrobot_tpu_torch.ops.cuda_basis_single import (
    aligned, basis_contract_single, basis_contract_single_plain)
from spectrobot_tpu_torch.ops.cuda_single import (
    accumulate_single, accumulate_single_plain)
from spectrobot_tpu_torch.ops.cuda_transpose import (
    MAX_ROWS as TRANSPOSE_ROWS, basis_transpose_batch,
    basis_transpose_batch_plain)
from spectrobot_tpu_torch.ops.opacity import (
    Engine, _basis, with_compute_dtype)

# The most coefficient rows one kernel launch takes: the rows' sums live in
# each lane's registers (csrc/basis_contract.cuh MAX_ROWS, checked against
# the library when it is loaded).  A call with more rows launches once a
# row group (:func:`row_spans`).
MAX_ROWS = 223

# Kernel launches made by basis_contract_batch in this process.
LAUNCHES = 0
_LIB = None


def basis_contract_batch_plain(nu_grid, nu_c, sx, y, C1, C2, C3, C4, *,
                               cutoff_cm1: Optional[float] = 25.0,
                               chi_b: Optional[torch.Tensor] = None,
                               variant: str = "humlicek4") -> torch.Tensor:
    """The plain PyTorch version of :func:`basis_contract_batch`, any dtype
    and device: nu_c/sx/y [B, L], C1..C4 [B, R, L], chi_b [B, L] or None ->
    [B, R, P] in ``nu_grid``'s dtype.

    Every line is evaluated at every point (pointwise gradient of the
    ``variant`` evaluator, cutoff mask) and contracted with
    ``torch.matmul``.  States are taken in groups
    so that one (state, line, point) slab holds at most ``_PLAIN_SLAB``
    elements.
    """
    B, L = nu_c.shape
    R = C1.shape[1]
    dt = nu_grid.dtype
    P = nu_grid.shape[0]
    chunk = min(max(L, 1), 256)
    group = max(1, _PLAIN_SLAB // (chunk * max(P, 1)))
    out = torch.zeros((B, R, P), dtype=dt, device=nu_grid.device)
    for b0 in range(0, B, group):
        g = slice(b0, b0 + group)
        for lo in range(0, L, chunk):
            sl = (g, slice(lo, lo + chunk))
            basis = _basis(nu_grid, nu_c[sl].to(dt), sx[sl].to(dt),
                           y[sl].to(dt),
                           None if chi_b is None else chi_b[sl].to(dt),
                           cutoff_cm1=cutoff_cm1, variant=variant)
            for C, b in zip((C1, C2, C3, C4), basis):
                out[g] += torch.matmul(C[g, :, lo:lo + chunk].to(dt), b)
    return out


def _check(nu_grid, nu_c, sx, y, C, active, chi_b, *, kernel: bool) -> None:
    """Raise on inputs of the wrong shape or on mixed devices; with
    ``kernel``, also on what the kernel does not take (more states than a
    launch's grid holds, a dtype other than float32, non-contiguous
    tensors)."""
    if nu_grid.dim() != 1:
        raise ValueError(f"nu_grid must be 1-D, got {tuple(nu_grid.shape)}")
    if nu_c.dim() != 2 or C[0].dim() != 3:
        raise ValueError(f"nu_c must be [B, L] and C1 [B, R, L], got "
                         f"{tuple(nu_c.shape)} and {tuple(C[0].shape)}")
    B, L = nu_c.shape
    R = C[0].shape[1]
    if kernel and B > 65535:
        raise ValueError(f"at most 65535 states per call, got {B}")
    want = {"nu_c": (nu_c, (B, L)), "sx": (sx, (B, L)), "y": (y, (B, L))}
    for k, c in enumerate(C, 1):
        want[f"C{k}"] = (c, (B, R, L))
    if chi_b is not None:
        want["chi_b"] = (chi_b, (B, L))
    if active is not None:
        want["active"] = (active, (B,))
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
        if not kernel or name == "active":
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def row_spans(R: int) -> list:
    """[(r0, r1)]: ``R`` coefficient rows cut into the fewest groups of at
    most ``MAX_ROWS``, as even as the count allows (their sizes differ by
    one at most), in order."""
    n = max(1, -(-R // MAX_ROWS))
    q, extra = divmod(R, n)
    spans, r0 = [], 0
    for g in range(n):
        spans.append((r0, r0 + q + (g < extra)))
        r0 = spans[-1][1]
    return spans


def contract_row_groups(C, out: torch.Tensor, contract) -> torch.Tensor:
    """Fill ``out`` [B, R, ...] by row groups: for each span of
    :func:`row_spans`, ``contract(C_group, out_group)`` with C1..C4's rows
    of the span ([B, G, L] each) and ``out``'s rows of the span (a view it
    writes).  The rows of a contraction are independent, so the groups
    give what one call over every row gives; each group evaluates the
    basis again."""
    for r0, r1 in row_spans(C[0].shape[1]):
        contract([c[:, r0:r1] for c in C], out[:, r0:r1])
    return out


def _library() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        from spectrobot_tpu_torch.kernels import build

        lib = build.load("basis_batch")
        geometry = (lib.basis_batch_tile_p(), lib.basis_batch_block_l(),
                    lib.basis_batch_sub_l(), lib.basis_batch_max_rows())
        if geometry != (TILE_P, BLOCK_L, SUB_L, MAX_ROWS):
            raise RuntimeError(f"kernel geometry {geometry} != wrapper "
                               f"{(TILE_P, BLOCK_L, SUB_L, MAX_ROWS)}")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.basis_batch_launch.argtypes = [ptr] * 13 + [
            i32, i32, i32, i32, ctypes.c_float, ptr]
        lib.basis_batch_launch.restype = i32
        lib.basis_batch_error_string.argtypes = [i32]
        lib.basis_batch_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def basis_contract_batch(nu_grid: torch.Tensor, windows: Windows,
                         nu_c: torch.Tensor, sx: torch.Tensor, y: torch.Tensor,
                         C1: torch.Tensor, C2: torch.Tensor,
                         C3: torch.Tensor, C4: torch.Tensor,
                         active: Optional[torch.Tensor] = None, *,
                         cutoff_cm1: Optional[float] = 25.0,
                         chi_b: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Batched basis contraction (counterpart of the reference's
    ``basis_contract_pallas_batch_jit``): nu_grid [P] (offset coordinates),
    nu_c/sx/y [B, L], C1..C4 [B, R, L], chi_b [B, L] or None, all on one
    device -> [B, R, P].  CUDA tensors must be float32; CPU tensors go to
    :func:`basis_contract_batch_plain` in any dtype.

    ``windows``: the scene's ``cuda_opacity.Windows``, as K1 takes them
    (the plain version needs none).
    ``active`` [B] (bool or int; None: derived from C1..C4): states whose
    rows are all zero, which the kernel skips; the caller may pass a
    cheaper sufficient statistic (the line sum's tangent passes
    amps != 0 | C1 != 0, since C2..C4 are amps-scaled).

    Any R: more than ``MAX_ROWS`` rows are cut into row groups
    (:func:`contract_row_groups`), one launch a group.  The kernel writes
    [B, G, Pp] rows of its own, so a group whose rows of the [B, R, Pp]
    output are not contiguous (B > 1) goes to a buffer of its own, copied
    into them: one [B, G, Pp] buffer and one device copy a group.
    """
    C = (C1, C2, C3, C4)
    on_cpu = nu_grid.device.type == "cpu"
    _check(nu_grid, nu_c, sx, y, C, active, chi_b, kernel=not on_cpu)
    if on_cpu:
        return basis_contract_batch_plain(nu_grid, nu_c, sx, y, *C,
                                          cutoff_cm1=cutoff_cm1, chi_b=chi_b)
    if nu_grid.device.type != "cuda":
        raise ValueError(f"no basis kernel for device {nu_grid.device}")
    B, L = nu_c.shape
    R = C1.shape[1]
    P = nu_grid.shape[0]
    check_windows(nu_grid, windows, L, cutoff_cm1)
    win = windows
    lib = _library()

    dev = nu_grid.device
    Pp, Lp = win.nu_pad.shape[0], _round_up(max(L, BLOCK_L), BLOCK_L)
    nuc_d = pad_lines(nu_c, Lp, win.far)
    sx_d, y_d = pad_lines(sx, Lp, 1e6), pad_lines(y, Lp, 1e6)
    chi_d = None if chi_b is None else pad_lines(chi_b, Lp, 0.0)
    if active is None:
        active = torch.stack([(c != 0).flatten(1).any(1) for c in C]).any(0)
    active = active.to(torch.int32).contiguous()
    out = torch.empty((B, R, Pp), dtype=torch.float32, device=dev)
    cut = math.inf if cutoff_cm1 is None else float(cutoff_cm1)

    def launch(Cg, out_g):
        global LAUNCHES
        G = Cg[0].shape[1]
        C_d = [aligned(pad_lines(c, Lp, 0.0)) for c in Cg]
        dst = (out_g if out_g.is_contiguous() else
               torch.empty((B, G, Pp), dtype=torch.float32, device=dev))
        rc = lib.basis_batch_launch(
            win.nu_pad.data_ptr(), nuc_d.data_ptr(), sx_d.data_ptr(),
            y_d.data_ptr(), None if chi_d is None else chi_d.data_ptr(),
            *(c.data_ptr() for c in C_d), win.starts.data_ptr(),
            win.counts.data_ptr(), active.data_ptr(), dst.data_ptr(), B, G,
            Pp, Lp, cut, stream)
        LAUNCHES += 1
        if rc != 0:
            msg = lib.basis_batch_error_string(rc).decode()
            raise RuntimeError(f"basis_batch kernel launch failed: CUDA "
                               f"error {rc} ({msg})")
        if dst is not out_g:
            out_g.copy_(dst)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        contract_row_groups(C, out, launch)
    return out[:, :, :P]


def _plain_engine(name: str, variant: str) -> Engine:
    """The plain versions of the five kernels as an engine, Re w by the
    ``variant`` evaluator; they need no window table."""
    def accumulate(nu_grid, windows, *args, **kw):
        return accumulate_batch_plain(nu_grid, *args, variant=variant, **kw)

    def contract(nu_grid, windows, nu_c, sx, y, C1, C2, C3, C4, active=None,
                 **kw):
        return basis_contract_batch_plain(nu_grid, nu_c, sx, y, C1, C2, C3,
                                          C4, variant=variant, **kw)

    def transpose(nu_grid, windows, *args, **kw):
        return basis_transpose_batch_plain(nu_grid, *args, variant=variant,
                                           **kw)

    def accumulate_single(nu_grid, windows, *args, **kw):
        return accumulate_single_plain(nu_grid, *args, variant=variant, **kw)

    def contract_single(nu_grid, windows, *args, **kw):
        return basis_contract_single_plain(nu_grid, *args, variant=variant,
                                           **kw)

    return Engine(name, accumulate, contract, transpose, None,
                  accumulate_single, contract_single, variant)


# The line sum's engines (ops.opacity.LineSumOp, AccumulateOp):
# - KERNELS, the five kernels, which compute in float32 on CUDA tensors: a
#   float64 pipeline hands them float32 copies of its inputs and gets their
#   results back in float64 (ops.opacity.with_compute_dtype), as the
#   reference runs its float32 Pallas kernels under x64; on CPU tensors
#   their plain versions, in the caller's dtype;
# - PLAIN, the plain versions on any device and dtype, which need no window
#   table: the reference for the kernels on the card, and with
#   compute.use_pallas = false the counterpart of the reference's XLA
#   engine there;
# - WEIDEMAN, the plain versions with the Weideman evaluator on any device
#   and dtype: the reference runs that variant only on its XLA engine, and
#   no kernel evaluates it.
KERNELS = with_compute_dtype(
    Engine("kernels", accumulate_batch, basis_contract_batch,
           basis_transpose_batch, TRANSPOSE_ROWS, accumulate_single,
           basis_contract_single), torch.float32)
PLAIN = _plain_engine("plain", "humlicek4")
WEIDEMAN = _plain_engine("weideman", "weideman")


def engine_for(variant: str) -> Engine:
    """The engine of an evaluator: ``KERNELS`` for humlicek4, ``WEIDEMAN``
    for weideman (the reference's ``_engine`` takes its Pallas kernels only
    for humlicek4); any other variant raises a ValueError."""
    engines = {"humlicek4": KERNELS, "weideman": WEIDEMAN}
    if variant not in engines:
        raise ValueError(f"unknown voigt variant {variant!r}")
    return engines[variant]
