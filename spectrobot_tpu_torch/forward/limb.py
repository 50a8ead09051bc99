"""Multi-layer limb/nadir forward model (port of the single-device kernel
path of ``spectrobot_tpu.forward.limb``): Curtis-Godson states -> one
batched opacity line sum over every (ray, layer) state -> source assembly
-> segment RT.

Only local thermodynamic equilibrium is ported: both per-line amplitude
weights are 1 (the reference's ``data.nlte.weights_for_layer`` without a
non-LTE state), so the emission depth equals the absorption depth and the
source function is B_nu(T_air).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from spectrobot_tpu_torch.forward.geometry import PathCG
from spectrobot_tpu_torch.forward.rt import layer_path_radiance
from spectrobot_tpu_torch.ops.cuda_basis import KERNELS
from spectrobot_tpu_torch.ops.cuda_opacity import Windows
from spectrobot_tpu_torch.ops.opacity import (
    Engine, LineSumOp, line_kernel_inputs)
from spectrobot_tpu_torch.ops.planck import planck_nu
from spectrobot_tpu_torch.ops.strengths import DeviceLines


class LayerOptics(NamedTuple):
    dtau: torch.Tensor     # [R, NL, P] one-crossing optical depth
    source: torch.Tensor   # [R, NL, P] source-function radiance


def _tau_prologue(lines: DeviceLines, cg: PathCG):
    """Stage 1 for every (ray, layer) state at once: CG states -> flat
    kernel inputs (nu_c, scale_x, y) [B, L] and amps [B, 2, L], B = R*NL."""
    R, NL, _ = cg.u.shape
    sp = lines.species_idx
    u_line_cm2 = cg.u[:, :, sp] * 1.0e-4               # [R, NL, L] one side
    # LTE: absorption and emission weights are both 1.
    amps = torch.stack([u_line_cm2, u_line_cm2], dim=-2)
    kl = line_kernel_inputs(lines, cg.T_sp[:, :, sp], cg.p_sp[:, :, sp],
                            cg.p_self_sp[:, :, sp], amps)
    L = lines.n_lines
    return (kl.nu_c.reshape(R * NL, L), kl.scale_x.reshape(R * NL, L),
            kl.y.reshape(R * NL, L), kl.amps.reshape(R * NL, 2, L))


def layer_tau_kernel(nu_off: torch.Tensor, lines: DeviceLines, cg: PathCG,
                     windows: Windows, *,
                     cutoff_cm1: Optional[float] = 25.0,
                     engine: Engine = KERNELS):
    """One batched line sum over the whole (ray x layer) batch (the
    counterpart of the reference's ``layer_tau_pallas``), differentiable in
    forward mode (``ops.opacity.LineSumOp``: under ``torch.func.jacfwd`` one
    K1 and one K2 call for the whole Jacobian).

    ``nu_off``: the grid in offset coordinates (nu - lines.nu_ref), staged
    from float64 by the caller.  The kernel inputs are cast to its dtype.
    ``engine``: ``ops.cuda_basis.KERNELS`` (the kernels on CUDA tensors) or
    ``PLAIN`` (their plain versions).  ``windows``: the scene's window table
    (``ops.cuda_opacity.line_windows`` of ``nu_off`` and ``lines.nu0``).
    Returns (dtau, dtau_em), each [R, NL, P].
    """
    R, NL, _ = cg.u.shape
    dt = nu_off.dtype
    nu_c, sx, y, amps = (a.to(dt).contiguous()
                         for a in _tau_prologue(lines, cg))
    op = LineSumOp(engine, windows, cutoff_cm1)
    out = op(nu_off, nu_c, sx, y, amps)                # [B, 2, P]
    out = out.reshape(R, NL, 2, nu_off.shape[0])
    return out[:, :, 0, :], out[:, :, 1, :]


def optics_from_tau(nu_grid, cg: PathCG, dtau, dtau_em) -> LayerOptics:
    """Source assembly: S_nu = B_nu(T_air) * k_em / k_abs (LTE: ratio 1).

    The ratio threshold keeps dtau^2 in normal float range (a division's
    tangent squares the denominator): 1e-16 in float32, 1e-150 in float64.
    """
    B = planck_nu(nu_grid[None, None, :], cg.T_air[:, :, None])
    tiny = 1e-150 if dtau.dtype == torch.float64 else 1e-16
    ratio = dtau_em / torch.clamp(dtau, min=tiny)
    source = B * torch.where(dtau > tiny, ratio, 1.0)
    return LayerOptics(dtau=dtau, source=source)


def path_radiance(optics: LayerOptics, cg: PathCG,
                  I_background: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Integrate layer optics in observer-first segment order -> [R, P]."""
    return layer_path_radiance(optics.dtau, optics.source, cg.seg_layer,
                               I_background)


def downwelling_radiance(optics: LayerOptics, cg: PathCG) -> torch.Tensor:
    """Sky radiance arriving at the surface [R, P]: the same layer optics
    integrated surface-first (reversed segment order), deep space behind."""
    return layer_path_radiance(optics.dtau, optics.source,
                               torch.flip(cg.seg_layer, dims=(0,)), None)


def tau_radiance_epilogue(nu_grid, cg: PathCG, dtau, dtau_em,
                          I_background: Optional[torch.Tensor] = None,
                          is_limb: bool = True,
                          emissivity: float = 1.0) -> torch.Tensor:
    """Radiance from line-sum depths [R, NL, P]: assemble sources, and for a
    nadir path over a grey surface (``is_limb=False``, ``I_background`` =
    eps B(T_s)) add the Lambertian reflected downwelling."""
    optics = optics_from_tau(nu_grid, cg, dtau, dtau_em)
    if not is_limb and emissivity < 1.0:
        I_background = I_background + (1.0 - emissivity) * \
            downwelling_radiance(optics, cg)
    return path_radiance(optics, cg, I_background)


def radiance_from_tau(nu_grid, cg: PathCG, dtau, dtau_em, T_surface=None,
                      emissivity: float = 1.0,
                      I_background: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """RT epilogue: limb when ``T_surface`` is None (deep space or
    ``I_background`` behind), nadir over a grey surface otherwise."""
    if T_surface is None:
        return tau_radiance_epilogue(nu_grid, cg, dtau, dtau_em,
                                     I_background=I_background)
    I_bg = emissivity * planck_nu(nu_grid, T_surface)
    I_bg = torch.broadcast_to(I_bg, (dtau.shape[0], nu_grid.shape[0]))
    return tau_radiance_epilogue(nu_grid, cg, dtau, dtau_em,
                                 I_background=I_bg, is_limb=False,
                                 emissivity=emissivity)
