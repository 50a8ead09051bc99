"""Opacity accumulation, plain PyTorch (port of the stage-1 prologue and the
``accumulate_jnp`` hot loop of ``spectrobot_tpu.ops.opacity``).

Stage 1 (:func:`line_kernel_inputs`): thermodynamic state -> flat per-line
kernel inputs (shifted center, x scale, y, amplitudes with every prefactor
folded in, and the chi wing slopes).  Stage 2 (:func:`accumulate_plain`;
the CUDA kernels in :mod:`spectrobot_tpu_torch.ops.cuda_opacity` (batched)
and :mod:`spectrobot_tpu_torch.ops.cuda_single` (one state)):

    out[o, p] = sum_i amps[o, i] * Re w(x_ip, y_i) * chi_ip * [|dnu| <= cut]
    x_ip = (nu[p] - nu_c[i]) * scale_x[i]

Derivatives (the counterparts of the reference's ``make_accumulate_op``):
:class:`LineSumOp` for a batch of states, :func:`make_accumulate_op` for
one state.  Forward mode goes through the basis contraction (K2 batched,
K4 at one state), reverse mode through its transpose (K5), or plain
autograd through :func:`line_sum_plain_ad`; :func:`ad_mode` reads the
reference's ``analytic_jvp`` switch.  :func:`cross_sections` is the
reference's public per-state interface on top of them.

The evaluator of Re w is ``variant``: Humlicek's w4 (``"humlicek4"``, what
the kernels evaluate) or Weideman's approximation (``"weideman"``, plain
PyTorch only, as the reference runs it only on its XLA engine).  An
:class:`Engine` carries its variant, so every path a line sum takes
(forward, ``jacfwd``, reverse mode, one state, the mesh, the table builds)
follows the engine it is given.  It also carries the dtype its primitives
compute in (:func:`with_compute_dtype`): the kernels' engine computes in
float32 on the card, so a float64 pipeline runs them on float32 copies of
its inputs and gets primals, tangents and cotangents back in float64, as
the reference runs its float32 kernels under x64.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from spectrobot_tpu_torch.constants import SQRT_LN2, SQRT_LN2_PI
from spectrobot_tpu_torch.ops.chi import CHI_DELTA1
from spectrobot_tpu_torch.ops.strengths import (
    DeviceLines, doppler_hwhm, line_strength, lorentz_hwhm,
    pressure_shifted_center,
)
from spectrobot_tpu_torch.ops.voigt import (
    wofz_humlicek4, wofz_humlicek4_grad, wofz_weideman, wofz_weideman_grad)


def _evaluator(variant: str, grad: bool):
    """The Faddeeva evaluator of ``variant``: (x, y) -> (wr, wi), or with
    ``grad`` -> (wr, wi, dK/dx, dK/dy)."""
    if variant == "humlicek4":
        return wofz_humlicek4_grad if grad else wofz_humlicek4
    if variant == "weideman":
        return wofz_weideman_grad if grad else wofz_weideman
    raise ValueError(f"unknown voigt variant {variant!r}")


class KernelLines(NamedTuple):
    """Flat per-line inputs of the accumulation ([..., L], amps
    [..., n_out, L])."""
    nu_c: torch.Tensor
    scale_x: torch.Tensor
    y: torch.Tensor
    amps: torch.Tensor
    chi_b: Optional[torch.Tensor] = None   # wing slope per line; None = off


def line_kernel_inputs(lines: DeviceLines, T, p_pa, p_self_pa=0.0,
                       amp_weights: Optional[torch.Tensor] = None,
                       chi=None) -> KernelLines:
    """Stage-1 prologue.  T / p_pa / p_self_pa: scalars or per-line tensors
    [..., L]; amp_weights [..., n_out, L] (default one all-ones row).
    ``chi`` = (``ops.chi.ChiProfile``, row_mask [n_species] bool): per-line
    sub-Lorentzian wing slopes b(T) for the profile's species (0 = off)."""
    S = line_strength(lines, T)
    ad = doppler_hwhm(lines, T)
    gl = lorentz_hwhm(lines, T, p_pa, p_self_pa)
    nu_c = pressure_shifted_center(lines, p_pa)
    inv_ad = 1.0 / ad
    base = S * (SQRT_LN2_PI * inv_ad)
    amps = (base.unsqueeze(-2) if amp_weights is None
            else amp_weights * base.unsqueeze(-2))
    chi_b = None
    if chi is not None:
        profile, row_mask = chi
        mask = torch.as_tensor(row_mask, dtype=torch.bool,
                               device=base.device)[lines.species_idx]
        T_line = torch.broadcast_to(torch.as_tensor(
            T, dtype=base.dtype, device=base.device), base.shape)
        chi_b = torch.where(mask, profile.slope(T_line).to(base.dtype), 0.0)
    return KernelLines(nu_c=nu_c, scale_x=SQRT_LN2 * inv_ad,
                       y=SQRT_LN2 * gl * inv_ad, amps=amps, chi_b=chi_b)


def _line_sum(nu, nu_c, sx, y, amps, chi_b=None, *, cutoff_cm1,
              variant: str = "humlicek4"):
    """One dense slab of the line sum: lines [..., c], amps [..., n_out, c]
    -> [..., n_out, P], Re w of ``variant`` at each of the (c x P) pairs."""
    dnu = nu - nu_c.unsqueeze(-1)                      # [..., c, P]
    x = sx.unsqueeze(-1) * dnu
    wr, _ = _evaluator(variant, False)(
        x, torch.broadcast_to(y.unsqueeze(-1), x.shape))
    if chi_b is not None:
        wr = wr * torch.exp(-chi_b.unsqueeze(-1) * torch.clamp(
            torch.abs(dnu) - CHI_DELTA1, min=0.0))
    if cutoff_cm1 is not None:
        wr = torch.where(torch.abs(dnu) <= cutoff_cm1, wr, 0.0)
    return torch.matmul(amps, wr)


def accumulate_plain(nu_grid: torch.Tensor, kl: KernelLines, *,
                     chunk: int = 256,
                     cutoff_cm1: Optional[float] = 25.0,
                     variant: str = "humlicek4") -> torch.Tensor:
    """Stage-2 line sum in plain torch, any dtype: lines [..., L], amps
    [..., n_out, L] -> [..., n_out, P] in ``nu_grid``'s dtype, Re w by the
    ``variant`` evaluator.  The line axis is cut into ``chunk``-line slabs
    to bound the (chunk x P) intermediates."""
    dt = nu_grid.dtype
    nu_c, sx, y, amps, chi_b = (None if a is None else a.to(dt) for a in kl)
    out = torch.zeros(amps.shape[:-1] + nu_grid.shape, dtype=dt,
                      device=nu_grid.device)
    for lo in range(0, amps.shape[-1], chunk):
        sl = slice(lo, lo + chunk)
        out += _line_sum(nu_grid, nu_c[..., sl], sx[..., sl], y[..., sl],
                        amps[..., sl], None if chi_b is None else
                        chi_b[..., sl], cutoff_cm1=cutoff_cm1,
                        variant=variant)
    return out


# ---------------------------------------------------------------------------
# Analytic tangent of the line sum
# ---------------------------------------------------------------------------
#
# The tangent of out[o, p] = sum_i amps[o, i] K(x_ip, y_i), with
# x_ip = sx_i (nu_p - nu_c_i), decomposes over four tangent-independent
# per-pair basis functions {K, Kx = dK/dx, xKx = x dK/dx, Ky = dK/dy}:
#
#     d out = [d_amps] K + [-amps sx d_nu_c] Kx + [amps d_sx / sx] xKx
#           + [amps d_y] Ky
#
# so under torch.func.jacfwd the basis is evaluated once and every Jacobian
# column is a contraction against it.  The partials come from the
# closed-form derivative of the approximant the primal evaluates
# (voigt.wofz_humlicek4_grad or wofz_weideman_grad), which is per-pair
# stable in float32; chi scales all four basis values and is constant in
# the tangent (the reference's frozen-chi convention).


def _basis(nu_grid, nc, s, yy, cb=None, *, cutoff_cm1,
           variant: str = "humlicek4"):
    """The basis (K, Kx, xKx, Ky) of lines [..., c] at every point of
    ``nu_grid`` [P] -> four [..., c, P] tensors, by the ``variant``
    evaluator's closed-form gradient."""
    dnu = nu_grid - nc.unsqueeze(-1)
    x = s.unsqueeze(-1) * dnu
    wr, _, kx, ky = _evaluator(variant, True)(
        x, torch.broadcast_to(yy.unsqueeze(-1), x.shape))
    if cb is not None:
        ch = torch.exp(-cb.unsqueeze(-1) * torch.clamp(
            torch.abs(dnu) - CHI_DELTA1, min=0.0))
        wr, kx, ky = wr * ch, kx * ch, ky * ch
    if cutoff_cm1 is not None:
        m = (torch.abs(dnu) <= cutoff_cm1).to(x.dtype)
        wr, kx, ky = wr * m, kx * m, ky * m
    return wr, kx, x * kx, ky


def tangent_transpose_plain(nu_grid, nu_c, sx, y, ct, chi_b=None, *,
                            chunk: int = 256,
                            cutoff_cm1: Optional[float] = 25.0,
                            variant: str = "humlicek4"):
    """The cotangent projections of the basis, plain PyTorch, any dtype:
    lines [..., L], cotangent rows ct [..., R, P] -> (AbK, AbKx, AbxKx,
    AbKy), each [..., R, L], with Ab_k[r, i] = sum_p ct[r, p] basis_k(p, i)
    over the same :func:`_basis` the tangent contracts (the batched
    counterpart of the reference's ``_tangent_transpose`` before its
    epilogue, :func:`transpose_epilogue`).  The line axis is cut into
    ``chunk``-line slabs."""
    dt = nu_grid.dtype
    ct = ct.to(dt)
    outs = ([], [], [], [])
    for lo in range(0, nu_c.shape[-1], chunk):
        sl = slice(lo, lo + chunk)
        basis = _basis(nu_grid, nu_c[..., sl].to(dt), sx[..., sl].to(dt),
                       y[..., sl].to(dt),
                       None if chi_b is None else chi_b[..., sl].to(dt),
                       cutoff_cm1=cutoff_cm1, variant=variant)
        for o, b in zip(outs, basis):
            o.append(torch.matmul(ct, b.transpose(-1, -2)))
    return tuple(torch.cat(o, dim=-1) for o in outs)


def transpose_epilogue(sx, amps, AbK, AbKx, AbxKx, AbKy):
    """Cotangents of the line inputs from the basis projections (the
    reference's ``acc_bwd`` epilogue): per-line sx [..., L], amps and the
    projections [..., R, L] -> (ct_nu_c, ct_sx, ct_y) [..., L] and ct_amps
    [..., R, L], summed over the R = n_out rows:

        ct_amps = AbK,  ct_nu_c = -sx sum_o amps AbKx,
        ct_sx = sum_o amps AbxKx / sx,  ct_y = sum_o amps AbKy
    """
    so = lambda M: torch.sum(M.to(amps.dtype) * amps, dim=-2)
    return (-sx * so(AbKx), so(AbxKx) / sx, so(AbKy), AbK.to(amps.dtype))


def line_sum_plain_ad(nu_grid, nu_c, sx, y, amps, chi_b=None, *,
                      chunk: int = 256, cutoff_cm1: Optional[float] = 25.0,
                      remat: bool = False,
                      variant: str = "humlicek4") -> torch.Tensor:
    """The line sum for plain autograd (the reference's plain-AD path,
    ``analytic_jvp=False``), any dtype and device: lines [..., L], amps
    [..., n_out, L] -> [..., n_out, P], summed out of place over
    ``chunk``-line slabs so both AD directions and ``torch.func`` trace it;
    Re w by the ``variant`` evaluator.

    Autograd keeps about 390 bytes per (state, line, point) of each slab
    for its backward pass.  ``remat=True`` recomputes each slab there
    instead (``torch.utils.checkpoint``), so the backward holds one slab at
    a time; ``torch.func.grad``/``jacrev`` do not take it."""
    dt = nu_grid.dtype
    nu_c, sx, y, amps = (a.to(dt) for a in (nu_c, sx, y, amps))
    chi_b = None if chi_b is None else chi_b.to(dt)
    out = None
    for lo in range(0, amps.shape[-1], chunk):
        sl = slice(lo, lo + chunk)
        args = (nu_grid, nu_c[..., sl], sx[..., sl], y[..., sl],
                amps[..., sl], None if chi_b is None else chi_b[..., sl])
        kw = dict(cutoff_cm1=cutoff_cm1, variant=variant)
        part = (torch.utils.checkpoint.checkpoint(
                    _line_sum, *args, use_reentrant=False, **kw)
                if remat else _line_sum(*args, **kw))
        out = part if out is None else out + part
    return out


def basis_coefficients(sx, amps, d_nu_c, d_sx, d_y, d_amps):
    """The coefficient rows (C1, C2, C3, C4) [..., n_out, L] of the basis
    for one tangent (per-line tangents [..., L], amps [..., n_out, L])."""
    return (d_amps, amps * (-sx * d_nu_c).unsqueeze(-2),
            amps * (d_sx / sx).unsqueeze(-2), amps * d_y.unsqueeze(-2))


def _tangent_via_basis(nu_grid, nu_c, sx, y, amps, d_nu_c, d_sx, d_y,
                       d_amps, chb=None, *, chunk: int = 256,
                       cutoff_cm1: Optional[float] = 25.0,
                       variant: str = "humlicek4"):
    """Plain tangent of the line sum for one tangent vector, any dtype:
    lines [..., L], amps [..., n_out, L] -> [..., n_out, P].  A tangent
    given as None is zero."""
    zero = lambda d, a: torch.zeros_like(a) if d is None else d
    C = basis_coefficients(sx, amps, zero(d_nu_c, nu_c), zero(d_sx, sx),
                           zero(d_y, y), zero(d_amps, amps))
    out = torch.zeros(amps.shape[:-1] + nu_grid.shape, dtype=nu_grid.dtype,
                      device=nu_grid.device)
    for lo in range(0, amps.shape[-1], chunk):
        sl = slice(lo, lo + chunk)
        basis = _basis(nu_grid, nu_c[..., sl], sx[..., sl], y[..., sl],
                       None if chb is None else chb[..., sl],
                       cutoff_cm1=cutoff_cm1, variant=variant)
        for c, b in zip(C, basis):
            out += torch.matmul(c[..., sl], b)
    return out


# ---------------------------------------------------------------------------
# The differentiable line sum
# ---------------------------------------------------------------------------


def ad_mode(analytic_jvp) -> Optional[str]:
    """The reference's ``analytic_jvp`` switch (``ops.opacity._ad_mode``):
    True/'fwd' -> analytic forward mode (:class:`LineSum`), 'rev' -> analytic
    reverse mode (:class:`LineSumVJP`), False/None -> plain autograd
    (:func:`line_sum_plain_ad`, either direction)."""
    if analytic_jvp is True or analytic_jvp == "fwd":
        return "fwd"
    if analytic_jvp == "rev":
        return "rev"
    if analytic_jvp in (False, None):
        return None
    raise ValueError(
        f"analytic_jvp must be True/'fwd', 'rev', or False; got "
        f"{analytic_jvp!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class Engine:
    """The primitives a differentiable line sum runs on, batched:

    accumulate(nu_grid, windows, nu_c, sx, y, amps, *, cutoff_cm1, chi_b)
        -> [B, 2, P]
    contract(nu_grid, windows, nu_c, sx, y, C1, C2, C3, C4, active, *,
             cutoff_cm1, chi_b) -> [B, R, P]
    transpose(nu_grid, windows, nu_c, sx, y, ct, *, cutoff_cm1, chi_b)
        -> (AbK, AbKx, AbxKx, AbKy), each [B, R, L]

    and at one state (lines [L], rows [n_out or R, L]):

    accumulate_single(nu_grid, windows, nu_c, sx, y, amps, *, cutoff_cm1,
                      chi_b) -> [n_out, P]
    contract_single(nu_grid, windows, nu_c, sx, y, C1, C2, C3, C4, *,
                    cutoff_cm1, chi_b) -> [R, P]

    (``ops.cuda_basis.KERNELS``: K1, K2, K5, K3 and K4;
    ``ops.cuda_basis.PLAIN``: their plain PyTorch versions;
    ``ops.cuda_basis.WEIDEMAN``: the plain versions with the Weideman
    evaluator).  ``transpose_rows``: the most cotangent rows one
    ``transpose`` call takes (None: any).  ``variant``: the evaluator of
    Re w its primitives use.  ``compute_dtype``: the dtype the primitives
    compute in on tensors of ``compute_devices`` (None: the caller's);
    :func:`with_compute_dtype` builds such an engine, whose primitives
    cast the caller's tensors there and their results back."""
    name: str
    accumulate: Callable
    contract: Callable
    transpose: Optional[Callable] = None
    transpose_rows: Optional[int] = None
    accumulate_single: Optional[Callable] = None
    contract_single: Optional[Callable] = None
    variant: str = "humlicek4"
    compute_dtype: Optional[torch.dtype] = None
    compute_devices: tuple = ()

    def dtype_on(self, device) -> Optional[torch.dtype]:
        """The dtype the primitives compute in on ``device``, or None where
        they compute in the caller's."""
        if torch.device(device).type in self.compute_devices:
            return self.compute_dtype
        return None

    def describe(self, dtype: torch.dtype, device) -> str:
        """The engine's name, and where a pipeline of ``dtype`` on
        ``device`` is cast for its primitives, the dtypes of both."""
        dt = self.dtype_on(device)
        if dt is None or dt == dtype:
            return self.name
        name = lambda d: str(d).removeprefix("torch.")
        return (f"{self.name} ({name(dt)} primitives in a {name(dtype)} "
                f"pipeline)")


_PRIMITIVES = ("accumulate", "contract", "transpose", "accumulate_single",
               "contract_single")


def _cast_primitive(fn: Callable, dtype: torch.dtype, devices: tuple):
    """``fn`` (a primitive: the grid, the window table, then tensors and
    keywords) computing in ``dtype`` on tensors of ``devices``: a call on a
    grid of another dtype there hands ``fn`` copies of its floating tensors
    in ``dtype`` and returns the result (each of a tuple) in the grid's
    dtype, as the reference casts its float32 kernels' results to
    ``result_type(nu_grid)``.  Any other call goes to ``fn`` untouched."""
    def call(nu_grid, windows, *args, **kw):
        back = nu_grid.dtype
        if nu_grid.device.type not in devices or back == dtype:
            return fn(nu_grid, windows, *args, **kw)
        to = lambda a: (a.to(dtype) if isinstance(a, torch.Tensor)
                        and a.is_floating_point() else a)
        out = fn(to(nu_grid), windows, *map(to, args),
                 **{k: to(v) for k, v in kw.items()})
        if isinstance(out, tuple):
            return tuple(o.to(back) for o in out)
        return out.to(back)
    return call


def with_compute_dtype(engine: Engine, dtype: torch.dtype,
                       devices=("cuda",)) -> Engine:
    """``engine`` with primitives that compute in ``dtype`` on tensors of
    ``devices`` (device types): a pipeline of another dtype there hands
    them copies of its grid, line parameters, rows, cotangents and chi in
    ``dtype`` and gets their results back in its own dtype, so tangents
    and cotangents keep the dtype of their primal (``ops.cuda_basis.
    KERNELS``: float32 kernels on CUDA inside a float64 pipeline, the
    reference's float32 Pallas kernels under x64)."""
    if engine.compute_dtype is not None:
        raise ValueError(f"engine {engine.name!r} already computes in "
                         f"{engine.compute_dtype}")
    devices = tuple(devices)
    prims = {f: _cast_primitive(getattr(engine, f), dtype, devices)
             for f in _PRIMITIVES if getattr(engine, f) is not None}
    return dataclasses.replace(engine, compute_dtype=dtype,
                               compute_devices=devices, **prims)


def engine_of(variant: str, engine: Optional[Engine] = None) -> Engine:
    """The engine of a line sum evaluating ``variant``: ``engine``, which
    must evaluate it (else a ValueError, as the reference refuses
    ``engine='pallas'`` for any variant but humlicek4, so that primal and
    tangent share one evaluator), or by default the variant's own
    (``ops.cuda_basis.engine_for``)."""
    if engine is None:
        from spectrobot_tpu_torch.ops.cuda_basis import engine_for
        return engine_for(variant)
    _evaluator(variant, False)
    if engine.variant != variant:
        raise ValueError(
            f"engine {engine.name!r} evaluates {engine.variant} only; use "
            f"ops.cuda_basis.engine_for({variant!r}) for variant="
            f"{variant!r} so primal and tangent share one evaluator")
    return engine


def _windows(op, nu_grid, nu_c):
    """The window table of a kernel call: ``op.windows``, else one built
    here, on the host, from the call's grid (unwrapped inside a Function's
    forward, also under ``torch.func`` transforms): from ``op.centers``
    (the lines' unshifted centers), or without them the all-blocks table
    (every line block for every tile, the reference's default at
    ``windows=None``)."""
    if op.windows is not None:
        return op.windows
    from spectrobot_tpu_torch.ops import cuda_opacity as co
    if op.centers is not None:
        return co.line_windows(nu_grid, op.centers, cutoff_cm1=op.cutoff_cm1)
    return co.all_block_windows(nu_grid, nu_c.shape[-1],
                                cutoff_cm1=op.cutoff_cm1)


def _broadcast(n: int, in_dims, tensors) -> list:
    """The tensors of a vmap rule with their batch of ``n`` leading (an
    unbatched one broadcast), contiguous; None stays None."""
    return [None if a is None else
            (a.expand((n,) + a.shape) if d is None else a.movedim(d, 0))
            .contiguous()
            for a, d in zip(tensors, in_dims)]


def _map_batch(fn, n: int, in_dims, args):
    """``fn`` over the ``n`` elements of a batch, one call each (the
    reference's ``lax.map`` for a batched grid, which has no flat form);
    the results stacked on a leading axis."""
    pick = lambda a, d, k: a if d is None else a.select(d, k)
    outs = [fn(*(pick(a, d, k) for a, d in zip(args, in_dims)))
            for k in range(n)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _flatten_states(fn, info, in_dims, args):
    """A structural vmap of a batched Function ``fn`` (args: the grid, the
    per-state tensors with a leading state axis B, the op): the vmap batch
    of n is flattened into B ([n, B, ...] -> [n*B, ...]), one call is made
    and the result unflattened (the reference's ``accB_rule`` and
    ``tanB_rule``).  A batched grid takes one call per element."""
    n = info.batch_size
    if in_dims[0] is not None:
        return _map_batch(fn, n, in_dims, args)
    grid, *states, op = args
    states = _broadcast(n, in_dims[1:-1], states)
    B = next(a.shape[1] for a in states if a is not None)
    out = fn(grid, *(None if a is None else a.reshape((n * B,) + a.shape[2:])
                     for a in states), op)
    unflat = lambda o: o.reshape((n, B) + o.shape[1:])
    return tuple(map(unflat, out)) if isinstance(out, tuple) else unflat(out)


@dataclasses.dataclass(frozen=True, eq=False)
class LineSumOp:
    """The batched line sum of one scene with analytic derivatives:
    ``op(nu_grid, nu_c, sx, y, amps, chi_b=None)`` -> [B, 2, P] for states
    [B, L], amps [B, 2, L].  The primal is one ``engine.accumulate`` call.

    ``mode='fwd'`` (:class:`LineSum`): under ``torch.func.jvp`` the tangent
    is one ``engine.contract`` call on the coefficient rows of
    :func:`basis_coefficients`; under ``torch.func.jacfwd`` (a vmap over
    tangents) :class:`BasisContract` folds every column into the rows, so a
    Jacobian costs one accumulate and one contract call.

    ``mode='rev'`` (:class:`LineSumVJP`): a gradient is one
    ``engine.transpose`` call and :func:`transpose_epilogue`; under
    ``torch.func.jacrev`` :class:`BasisTranspose` folds every cotangent
    into the rows.

    ``windows``: the scene's window table (``ops.cuda_opacity.Windows``).
    Not a tuple, so ``torch.func`` hands it to the Functions untouched.
    Without one, each call builds its table on the host from ``centers``
    (the lines' unshifted centers [L], ascending) or, without them, visits
    every line block."""
    engine: Engine
    windows: object
    cutoff_cm1: Optional[float] = 25.0
    mode: str = "fwd"
    centers: object = None

    def __call__(self, nu_grid, nu_c, sx, y, amps, chi_b=None):
        fn = LineSumVJP if self.mode == "rev" else LineSum
        return fn.apply(nu_grid, nu_c, sx, y, amps, chi_b, self)


class LineSum(torch.autograd.Function):
    """Primal through ``op.engine.accumulate``, tangent through
    :class:`BasisContract` (the counterpart of the reference's
    ``make_accumulate_op(engine='pallas', mode='fwd')``).  Chi is constant
    in the tangent; the grid has none."""

    @staticmethod
    def forward(nu_grid, nu_c, sx, y, amps, chi_b, op):
        return op.engine.accumulate(nu_grid, _windows(op, nu_grid, nu_c),
                                    nu_c, sx, y, amps,
                                    cutoff_cm1=op.cutoff_cm1, chi_b=chi_b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        nu_grid, nu_c, sx, y, amps, chi_b, op = inputs
        ctx.save_for_forward(nu_grid, nu_c, sx, y, amps, chi_b)
        ctx.op = op

    @staticmethod
    def jvp(ctx, _d_nu, d_nu_c, d_sx, d_y, d_amps, _d_chi, _d_op):
        nu_grid, nu_c, sx, y, amps, chi_b = ctx.saved_tensors
        zero = lambda d, a: torch.zeros_like(a) if d is None else d
        C1, C2, C3, C4 = basis_coefficients(
            sx, amps, zero(d_nu_c, nu_c), zero(d_sx, sx), zero(d_y, y),
            zero(d_amps, amps))
        # A sufficient statistic of a live state: C2..C4 are amps-scaled.
        active = (amps != 0).flatten(1).any(1) | (C1 != 0).flatten(1).any(1)
        return BasisContract.apply(nu_grid, nu_c, sx, y, C1, C2, C3, C4,
                                   active, chi_b, ctx.op)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _flatten_states(LineSum.apply, info, in_dims, args), 0


class BasisContract(torch.autograd.Function):
    """One ``op.engine.contract`` call: [B, R, P] from coefficient rows
    [B, R, L].  Its vmap rule (the reference's ``tanB_rule``) folds the
    tangent batch of ``torch.func.jacfwd`` (only the rows and ``active``
    batched) into the rows ([n_t, B, R, L] -> [B, n_t*R, L]), makes one
    call and unfolds the result; a structural batch (the line states
    batched) is flattened into B."""

    @staticmethod
    def forward(nu_grid, nu_c, sx, y, C1, C2, C3, C4, active, chi_b, op):
        return op.engine.contract(nu_grid, _windows(op, nu_grid, nu_c), nu_c,
                                  sx, y, C1, C2, C3, C4, active,
                                  cutoff_cm1=op.cutoff_cm1, chi_b=chi_b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, nu_grid, nu_c, sx, y, C1, C2, C3, C4, active,
             chi_b, op):
        args = (nu_grid, nu_c, sx, y, C1, C2, C3, C4, active, chi_b, op)
        if any(d is not None for d in in_dims[:4] + in_dims[9:10]):
            return _flatten_states(BasisContract.apply, info, in_dims,
                                   args), 0
        n_t = info.batch_size
        B, R, L = C1.shape[-3:]

        def fold(C, d):          # [n_t, B, R, L] -> [B, n_t * R, L]
            C = (C.expand(n_t, B, R, L) if d is None
                 else C.movedim(d, 0))
            return C.transpose(0, 1).reshape(B, n_t * R, L).contiguous()

        if in_dims[8] is not None:
            active = active.movedim(in_dims[8], 0).any(0)
        out = BasisContract.apply(
            nu_grid, nu_c, sx, y, *(fold(C, d) for C, d in
                                    zip((C1, C2, C3, C4), in_dims[4:8])),
            active, chi_b, op)
        return out.reshape(B, n_t, R, -1).transpose(0, 1), 0


class LineSumVJP(torch.autograd.Function):
    """Primal through ``op.engine.accumulate``, gradient through
    :class:`BasisTranspose` and :func:`transpose_epilogue` (the counterpart
    of the reference's ``make_accumulate_op(engine='pallas', mode='rev')``).
    The context keeps the flat inputs and no linearisation: the backward
    evaluates the basis anew.  Chi and the grid get zero cotangent (frozen
    chi).  Forward mode is refused, as JAX refuses it for a custom VJP.  A
    structural vmap is flattened into B."""

    @staticmethod
    def forward(nu_grid, nu_c, sx, y, amps, chi_b, op):
        return op.engine.accumulate(nu_grid, _windows(op, nu_grid, nu_c),
                                    nu_c, sx, y, amps,
                                    cutoff_cm1=op.cutoff_cm1, chi_b=chi_b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        nu_grid, nu_c, sx, y, amps, chi_b, op = inputs
        ctx.save_for_backward(nu_grid, nu_c, sx, y, amps, chi_b)
        ctx.op = op

    @staticmethod
    def backward(ctx, ct):
        nu_grid, nu_c, sx, y, amps, chi_b = ctx.saved_tensors
        Ab = BasisTranspose.apply(nu_grid, nu_c, sx, y, ct, chi_b, ctx.op)
        ct_nc, ct_sx, ct_y, ct_amps = transpose_epilogue(sx, amps, *Ab)
        return None, ct_nc, ct_sx, ct_y, ct_amps, None, None

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(
            "the line sum in reverse mode (analytic_jvp='rev') has no "
            "forward-mode derivative, as a JAX custom_vjp has none: use "
            "analytic_jvp=True for torch.func.jvp/jacfwd")

    @staticmethod
    def vmap(info, in_dims, *args):
        return _flatten_states(LineSumVJP.apply, info, in_dims, args), 0


class BasisTranspose(torch.autograd.Function):
    """One ``op.engine.transpose`` call: (AbK, AbKx, AbxKx, AbKy), each
    [B, R, L], from cotangent rows ct [B, R, P].  Its vmap rule folds the
    cotangent batch of ``torch.func.jacrev`` (only ``ct`` batched) into the
    rows ([n_ct, B, R, P] -> [B, n_ct*R, P]), makes one call, or the fewest
    calls of at most ``engine.transpose_rows`` rows, and unfolds the result
    (as :class:`BasisContract` folds the tangents of jacfwd); a structural
    batch (the line states batched) is flattened into B."""

    @staticmethod
    def forward(nu_grid, nu_c, sx, y, ct, chi_b, op):
        return tuple(op.engine.transpose(nu_grid, _windows(op, nu_grid, nu_c),
                                         nu_c, sx, y, ct,
                                         cutoff_cm1=op.cutoff_cm1,
                                         chi_b=chi_b))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, nu_grid, nu_c, sx, y, ct, chi_b, op):
        if any(d is not None for d in in_dims[:4] + in_dims[5:6]):
            return (_flatten_states(BasisTranspose.apply, info, in_dims,
                                    (nu_grid, nu_c, sx, y, ct, chi_b, op)),
                    (0, 0, 0, 0))
        n_ct = info.batch_size
        ct = ct.movedim(in_dims[4], 0)                   # [n_ct, B, R, P]
        _, B, R, P = ct.shape
        rows = ct.transpose(0, 1).reshape(B, n_ct * R, P)
        cap = op.engine.transpose_rows or n_ct * R
        parts = [BasisTranspose.apply(nu_grid, nu_c, sx, y,
                                      rows[:, r0:r0 + cap].contiguous(),
                                      chi_b, op)
                 for r0 in range(0, n_ct * R, cap)]
        unfold = lambda *o: torch.cat(o, dim=1).reshape(
            B, n_ct, R, -1).transpose(0, 1)
        return tuple(unfold(*o) for o in zip(*parts)), (0, 0, 0, 0)


# ---------------------------------------------------------------------------
# The line sum of one state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class AccumulateOp(LineSumOp):
    """The line sum of one state with analytic derivatives:
    ``op(nu_grid, nu_c, sx, y, amps, chi_b=None)`` -> [n_out, P] for lines
    [L], amps [n_out, L] (:func:`make_accumulate_op`).  The primal is one
    ``engine.accumulate_single`` call (K3 on the card).

    ``mode='fwd'`` (:class:`SingleLineSum`): a ``torch.func.jvp`` tangent
    is one ``engine.contract_single`` call (K4); under ``jacfwd``
    :class:`SingleBasisContract` folds every column into its rows.
    ``mode='rev'`` (:class:`SingleLineSumVJP`): a gradient is one
    ``engine.transpose`` call at B = 1 (K5) and :func:`transpose_epilogue`.
    A structural vmap (line inputs batched) promotes the call to the
    batched :class:`LineSum` / :class:`LineSumVJP`, which run K1, K2 and
    K5.  ``has_chi=False`` refuses a ``chi_b``."""
    has_chi: bool = False

    def __call__(self, nu_grid, nu_c, sx, y, amps, chi_b=None):
        if chi_b is not None and not self.has_chi:
            raise ValueError("chi_b given to a line sum built with "
                             "has_chi=False")
        fn = SingleLineSumVJP if self.mode == "rev" else SingleLineSum
        return fn.apply(nu_grid, nu_c, sx, y, amps, chi_b, self)


def make_accumulate_op(*, cutoff_cm1: Optional[float] = 25.0,
                       mode: str = "fwd", windows=None,
                       has_chi: bool = False,
                       engine: Optional[Engine] = None,
                       centers=None,
                       variant: str = "humlicek4") -> AccumulateOp:
    """The single-state line sum acc(nu_grid, nu_c, sx, y, amps,
    chi_b=None) -> [n_out, P] with analytic derivatives (the counterpart of
    the reference's ``make_accumulate_op(engine='pallas')`` at one state;
    :class:`AccumulateOp`).  ``nu_grid`` gets no derivative.

    ``mode``: 'fwd' (``torch.func.jvp``/``jacfwd``) or 'rev'
    (``torch.autograd.grad``, ``torch.func.grad``/``jacrev``).
    ``windows``: the ``ops.cuda_opacity.Windows`` of the grid and the
    lines' unshifted centers (``line_windows``); without it each call
    builds the table from ``centers`` (those centers [L], ascending), or,
    without them too, visits every line block (exact but slower).
    ``engine``: the engine of ``variant`` (default ``ops.cuda_basis.
    engine_for(variant)``: for humlicek4 ``KERNELS``, the kernels on CUDA
    tensors and their plain versions on the CPU; for weideman
    ``WEIDEMAN``), or ``PLAIN``; an engine of another variant raises a
    ValueError."""
    if mode not in ("fwd", "rev"):
        raise ValueError(f"mode must be 'fwd' or 'rev', got {mode!r}")
    return AccumulateOp(engine_of(variant, engine), windows, cutoff_cm1,
                        mode, centers, has_chi)


def _contiguous(*tensors):
    return tuple(None if a is None else a.contiguous() for a in tensors)


class SingleLineSum(torch.autograd.Function):
    """Primal through ``op.engine.accumulate_single``, tangent through
    :class:`SingleBasisContract` (the reference's ``acc0`` and ``tan0``).
    Chi is constant in the tangent; the grid has none.  Its vmap rule
    (``acc0_rule``) promotes a structural batch to :class:`LineSum`."""

    @staticmethod
    def forward(nu_grid, nu_c, sx, y, amps, chi_b, op):
        nu_c, sx, y, amps, chi_b = _contiguous(nu_c, sx, y, amps, chi_b)
        return op.engine.accumulate_single(
            nu_grid, _windows(op, nu_grid, nu_c), nu_c, sx, y, amps,
            cutoff_cm1=op.cutoff_cm1, chi_b=chi_b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        nu_grid, nu_c, sx, y, amps, chi_b, op = inputs
        ctx.save_for_forward(nu_grid, nu_c, sx, y, amps, chi_b)
        ctx.op = op

    @staticmethod
    def jvp(ctx, _d_nu, d_nu_c, d_sx, d_y, d_amps, _d_chi, _d_op):
        nu_grid, nu_c, sx, y, amps, chi_b = ctx.saved_tensors
        zero = lambda d, a: torch.zeros_like(a) if d is None else d
        C = basis_coefficients(sx, amps, zero(d_nu_c, nu_c), zero(d_sx, sx),
                               zero(d_y, y), zero(d_amps, amps))
        return SingleBasisContract.apply(nu_grid, nu_c, sx, y, *C, chi_b,
                                         ctx.op)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _promote(LineSum.apply, SingleLineSum.apply, info, in_dims,
                        args), 0


class SingleBasisContract(torch.autograd.Function):
    """One ``op.engine.contract_single`` call: [R, P] from coefficient rows
    [R, L].  Its vmap rule (the reference's ``tan0_rule``) folds the
    tangent batch of ``torch.func.jacfwd`` (only the rows batched) into the
    rows ([n_t, R, L] -> [n_t*R, L]), makes one call and unfolds the
    result; a structural batch promotes the call to :class:`BasisContract`.
    """

    @staticmethod
    def forward(nu_grid, nu_c, sx, y, C1, C2, C3, C4, chi_b, op):
        args = _contiguous(nu_c, sx, y, C1, C2, C3, C4, chi_b)
        return op.engine.contract_single(
            nu_grid, _windows(op, nu_grid, nu_c), *args[:7],
            cutoff_cm1=op.cutoff_cm1, chi_b=args[7])

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, nu_grid, nu_c, sx, y, C1, C2, C3, C4, chi_b, op):
        args = (nu_grid, nu_c, sx, y, C1, C2, C3, C4, chi_b, op)
        if any(d is not None for d in in_dims[:4] + in_dims[8:9]):
            # A structural batch: the batched contraction, every state live.
            def batched(nu_grid, nu_c, sx, y, C1, C2, C3, C4, chi_b, op):
                return BasisContract.apply(nu_grid, nu_c, sx, y, C1, C2, C3,
                                           C4, None, chi_b, op)
            return _promote(batched, SingleBasisContract.apply, info,
                            in_dims, args), 0
        n_t = info.batch_size
        R, L = C1.shape[-2:]
        fold = lambda C, d: (C.expand(n_t, R, L) if d is None
                             else C.movedim(d, 0)).reshape(n_t * R, L)
        out = SingleBasisContract.apply(
            nu_grid, nu_c, sx, y, *(fold(C, d) for C, d in
                                    zip((C1, C2, C3, C4), in_dims[4:8])),
            chi_b, op)
        return out.reshape(n_t, R, -1), 0


class SingleLineSumVJP(torch.autograd.Function):
    """Primal through ``op.engine.accumulate_single``, gradient through
    :class:`BasisTranspose` at B = 1 and :func:`transpose_epilogue` (the
    reference's ``make_accumulate_op(mode='rev')`` at one state); under
    ``torch.func.jacrev`` the cotangents fold into the transpose's rows.
    Chi and the grid get zero cotangent (frozen chi).  Forward mode is
    refused; a structural vmap promotes the call to :class:`LineSumVJP`."""

    @staticmethod
    def forward(nu_grid, nu_c, sx, y, amps, chi_b, op):
        return SingleLineSum.forward(nu_grid, nu_c, sx, y, amps, chi_b, op)

    @staticmethod
    def setup_context(ctx, inputs, output):
        nu_grid, nu_c, sx, y, amps, chi_b, op = inputs
        ctx.save_for_backward(nu_grid, nu_c, sx, y, amps, chi_b)
        ctx.op = op

    @staticmethod
    def backward(ctx, ct):
        nu_grid, nu_c, sx, y, amps, chi_b = ctx.saved_tensors
        one = lambda a: None if a is None else a.unsqueeze(0)
        Ab = BasisTranspose.apply(nu_grid, one(nu_c), one(sx), one(y),
                                  one(ct), one(chi_b), ctx.op)
        ct_nc, ct_sx, ct_y, ct_amps = transpose_epilogue(
            sx, amps, *(a.squeeze(0) for a in Ab))
        return None, ct_nc, ct_sx, ct_y, ct_amps, None, None

    @staticmethod
    def jvp(ctx, *tangents):
        return LineSumVJP.jvp(ctx, *tangents)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _promote(LineSumVJP.apply, SingleLineSumVJP.apply, info,
                        in_dims, args), 0


def _promote(batched, single, info, in_dims, args):
    """The vmap rule of a single-state Function (args: the grid, the
    state's tensors, the op): the vmap batch becomes the state axis of the
    ``batched`` Function, one call (the reference's ``acc0_rule`` and
    ``tan0_rule``); a batched grid takes one ``single`` call per
    element."""
    n = info.batch_size
    if in_dims[0] is not None:
        return _map_batch(single, n, in_dims, args)
    grid, *states, op = args
    return batched(grid, *_broadcast(n, in_dims[1:-1], states), op)


def cross_sections(nu_grid, lines: DeviceLines, T, p_pa, p_self_pa=0.0,
                   w_abs: Optional[torch.Tensor] = None,
                   w_em: Optional[torch.Tensor] = None, *,
                   chunk: int = 256, variant: str = "humlicek4",
                   cutoff_cm1: Optional[float] = 25.0, analytic_jvp=True,
                   nu_off: Optional[torch.Tensor] = None, chi=None,
                   engine: Optional[Engine] = None):
    """Absorption and emission cross sections [cm^2/molec] of one
    homogeneous state, each [P] (the reference's stable public interface).
    ``chi`` = (``ops.chi.ChiProfile``, row_mask): the sub-Lorentzian wing
    correction.

    ``analytic_jvp``: True/'fwd' (default) the single-state op in forward
    mode (:func:`make_accumulate_op`: K3 for the values, K4 for
    ``torch.func.jvp``/``jacfwd``), 'rev' in reverse mode (K3, and K5 at
    B = 1 for a gradient), False plain autograd through
    :func:`line_sum_plain_ad` in ``chunk``-line slabs.  Under a structural
    ``vmap`` (:func:`cross_sections_batch`) the op runs the batched kernels
    (K1, K2, K5).  ``nu_off``: the grid in offset coordinates staged from
    float64 (default ``nu_grid - lines.nu_ref``, exact only for a float64
    grid); the line inputs are cast to its dtype.  ``variant``: the
    evaluator of Re w, 'humlicek4' or 'weideman'.  ``engine``: the op's
    engine (default ``ops.cuda_basis.engine_for(variant)``: for humlicek4
    ``KERNELS``, on CUDA tensors the kernels, on CPU tensors their plain
    versions; for weideman ``WEIDEMAN``, plain PyTorch on any device); an
    engine of another variant raises a ValueError, as the reference's
    ``engine='pallas'`` does for weideman.  The kernels' window table is
    built on the host at each call from the grid and ``lines.nu0``."""
    engine = engine_of(variant, engine)
    ones = torch.ones(lines.n_lines, dtype=lines.sw.dtype,
                      device=lines.sw.device)
    wa = ones if w_abs is None else w_abs
    we = ones if w_em is None else w_em
    kl = line_kernel_inputs(lines, T, p_pa, p_self_pa,
                            amp_weights=torch.stack([wa, we]), chi=chi)
    if nu_off is None:
        nu_off = nu_grid - float(lines.nu_ref)
    dt = nu_off.dtype
    nu_c, sx, y, amps, chi_b = (None if a is None else a.to(dt) for a in kl)
    mode = ad_mode(analytic_jvp)
    if mode is None:
        out = line_sum_plain_ad(nu_off, nu_c, sx, y, amps, chi_b,
                                chunk=chunk, cutoff_cm1=cutoff_cm1,
                                variant=variant)
    else:
        op = make_accumulate_op(cutoff_cm1=cutoff_cm1, mode=mode,
                                has_chi=chi_b is not None, engine=engine,
                                centers=lines.nu0, variant=variant)
        out = op(nu_off, nu_c, sx, y, amps, chi_b)
    return out[0], out[1]


def cross_sections_batch(nu_grid, lines: DeviceLines, T_lay, p_lay,
                         p_self_lay, w_abs_lay=None, w_em_lay=None, **kw):
    """Per-layer cross sections: T_lay/p_lay/p_self_lay [n_lay], weights
    [n_lay, L] or None -> (sigma_abs, sigma_em), each [n_lay, P]:
    ``torch.func.vmap`` of :func:`cross_sections`, so the op's structural
    rule runs the batched kernels (K1 once; K1 and K2 under ``jacfwd``).
    Keywords as :func:`cross_sections`."""
    if w_abs_lay is None:
        return torch.func.vmap(lambda T, p, ps: cross_sections(
            nu_grid, lines, T, p, ps, None, None, **kw))(T_lay, p_lay,
                                                         p_self_lay)
    return torch.func.vmap(lambda T, p, ps, wa, we: cross_sections(
        nu_grid, lines, T, p, ps, wa, we, **kw))(T_lay, p_lay, p_self_lay,
                                                 w_abs_lay, w_em_lay)
