"""Opacity accumulation, plain PyTorch (port of the stage-1 prologue and the
``accumulate_jnp`` hot loop of ``spectrobot_tpu.ops.opacity``).

Stage 1 (:func:`line_kernel_inputs`): thermodynamic state -> flat per-line
kernel inputs (shifted center, x scale, y, amplitudes with every prefactor
folded in).  Stage 2 (:func:`accumulate_plain`; the CUDA kernel in
:mod:`spectrobot_tpu_torch.ops.cuda_opacity` for the batched production
call):

    out[o, p] = sum_i amps[o, i] * Re w(x_ip, y_i) * chi_ip * [|dnu| <= cut]
    x_ip = (nu[p] - nu_c[i]) * scale_x[i]
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from spectrobot_tpu.constants import SQRT_LN2, SQRT_LN2_PI
from spectrobot_tpu_torch.ops.strengths import (
    DeviceLines, doppler_hwhm, line_strength, lorentz_hwhm,
    pressure_shifted_center,
)
from spectrobot_tpu_torch.ops.voigt import wofz_humlicek4

# Sub-Lorentzian wing factor chi(|dnu|) = exp(-chi_b max(|dnu| - 3, 0))
# (the reference's ops.chi.CHI_DELTA1).
CHI_DELTA1 = 3.0


class KernelLines(NamedTuple):
    """Flat per-line inputs of the accumulation ([..., L], amps
    [..., n_out, L])."""
    nu_c: torch.Tensor
    scale_x: torch.Tensor
    y: torch.Tensor
    amps: torch.Tensor
    chi_b: Optional[torch.Tensor] = None   # wing slope per line; None = off


def line_kernel_inputs(lines: DeviceLines, T, p_pa, p_self_pa=0.0,
                       amp_weights: Optional[torch.Tensor] = None
                       ) -> KernelLines:
    """Stage-1 prologue.  T / p_pa / p_self_pa: scalars or per-line tensors
    [..., L]; amp_weights [..., n_out, L] (default one all-ones row)."""
    S = line_strength(lines, T)
    ad = doppler_hwhm(lines, T)
    gl = lorentz_hwhm(lines, T, p_pa, p_self_pa)
    nu_c = pressure_shifted_center(lines, p_pa)
    inv_ad = 1.0 / ad
    base = S * (SQRT_LN2_PI * inv_ad)
    amps = (base.unsqueeze(-2) if amp_weights is None
            else amp_weights * base.unsqueeze(-2))
    return KernelLines(nu_c=nu_c, scale_x=SQRT_LN2 * inv_ad,
                       y=SQRT_LN2 * gl * inv_ad, amps=amps)


def _line_sum(nu, nu_c, sx, y, amps, chi_b=None, *, cutoff_cm1):
    """One dense slab of the line sum: lines [..., c], amps [..., n_out, c]
    -> [..., n_out, P], pointwise w4 over the (c x P) pairs."""
    dnu = nu - nu_c.unsqueeze(-1)                      # [..., c, P]
    x = sx.unsqueeze(-1) * dnu
    wr, _ = wofz_humlicek4(x, torch.broadcast_to(y.unsqueeze(-1), x.shape))
    if chi_b is not None:
        wr = wr * torch.exp(-chi_b.unsqueeze(-1) * torch.clamp(
            torch.abs(dnu) - CHI_DELTA1, min=0.0))
    if cutoff_cm1 is not None:
        wr = torch.where(torch.abs(dnu) <= cutoff_cm1, wr, 0.0)
    return torch.matmul(amps, wr)


def accumulate_plain(nu_grid: torch.Tensor, kl: KernelLines, *,
                     chunk: int = 256,
                     cutoff_cm1: Optional[float] = 25.0) -> torch.Tensor:
    """Stage-2 line sum in plain torch, any dtype: lines [..., L], amps
    [..., n_out, L] -> [..., n_out, P] in ``nu_grid``'s dtype.  The line
    axis is cut into ``chunk``-line slabs to bound the (chunk x P)
    intermediates."""
    dt = nu_grid.dtype
    nu_c, sx, y, amps, chi_b = (None if a is None else a.to(dt) for a in kl)
    out = torch.zeros(amps.shape[:-1] + nu_grid.shape, dtype=dt,
                      device=nu_grid.device)
    for lo in range(0, amps.shape[-1], chunk):
        sl = slice(lo, lo + chunk)
        out += _line_sum(nu_grid, nu_c[..., sl], sx[..., sl], y[..., sl],
                        amps[..., sl], None if chi_b is None else
                        chi_b[..., sl], cutoff_cm1=cutoff_cm1)
    return out
