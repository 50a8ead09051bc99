"""Multi-layer limb/nadir forward model (port of the single-device kernel
path of ``spectrobot_tpu.forward.limb``): Curtis-Godson states -> one
batched opacity line sum over every (ray, layer) state -> source assembly
-> segment RT.  The public ``layer_optics``, ``limb_radiance`` and
``nadir_radiance`` take the reference's ``analytic_jvp`` switch: analytic
forward mode (K1 + K2), analytic reverse mode (K1 + K5) or plain autograd.

Each line enters the line sum with two amplitude rows, w_abs u and w_em u:
in local thermodynamic equilibrium both weights are 1; with a non-LTE state
(``nlte``, ``data.nlte.DeviceNLTE``) they are the population weights of
``data.nlte.layer_weights`` at each (ray, layer) state's kinetic
temperature, and the emission depth differs from the absorption depth.  The
source assembly forms S_nu = B_nu(T_air) k_em / k_abs.  A collision-induced
continuum (``cia``, ``ops.cia.DeviceCIA``) is added to both depths before
it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from spectrobot_tpu_torch.data.nlte import DeviceNLTE, layer_weights
from spectrobot_tpu_torch.forward.geometry import PathCG
from spectrobot_tpu_torch.forward.rt import layer_path_radiance
from spectrobot_tpu_torch.ops.cuda_basis import KERNELS
from spectrobot_tpu_torch.ops.chi import CHI_MAX_CUTOFF
from spectrobot_tpu_torch.ops.cia import cia_dtau
from spectrobot_tpu_torch.ops.cuda_opacity import Windows, line_windows
from spectrobot_tpu_torch.ops.opacity import (
    Engine, LineSumOp, ad_mode, line_kernel_inputs, line_sum_plain_ad)
from spectrobot_tpu_torch.ops.planck import planck_nu
from spectrobot_tpu_torch.ops.strengths import DeviceLines
from spectrobot_tpu_torch.utils.profiling import annotate


class LayerOptics(NamedTuple):
    dtau: torch.Tensor     # [R, NL, P] one-crossing optical depth
    source: torch.Tensor   # [R, NL, P] source-function radiance


def _tau_prologue(lines: DeviceLines, cg: PathCG,
                  nlte: Optional[DeviceNLTE] = None, chi=None):
    """Stage 1 for every (ray, layer) state at once: CG states -> flat
    kernel inputs (nu_c, scale_x, y) [B, L], amps [B, 2, L] (the rows
    w_abs u and w_em u) and the chi slopes [B, L] (None without ``chi``),
    B = R*NL."""
    R, NL, _ = cg.u.shape
    sp = lines.species_idx
    u_line_cm2 = cg.u[:, :, sp] * 1.0e-4               # [R, NL, L] one side
    w = layer_weights(nlte, lines, cg.T_air)
    if w is None:       # LTE: absorption and emission weights are both 1
        amps = torch.stack([u_line_cm2, u_line_cm2], dim=-2)
    else:
        amps = torch.stack([w[0] * u_line_cm2, w[1] * u_line_cm2], dim=-2)
    kl = line_kernel_inputs(lines, cg.T_sp[:, :, sp], cg.p_sp[:, :, sp],
                            cg.p_self_sp[:, :, sp], amps, chi=chi)
    L = lines.n_lines
    return (kl.nu_c.reshape(R * NL, L), kl.scale_x.reshape(R * NL, L),
            kl.y.reshape(R * NL, L), kl.amps.reshape(R * NL, 2, L),
            None if kl.chi_b is None else kl.chi_b.reshape(R * NL, L))


def layer_tau_kernel(nu_off: torch.Tensor, lines: DeviceLines, cg: PathCG,
                     windows: Windows, *,
                     cutoff_cm1: Optional[float] = 25.0,
                     engine: Engine = KERNELS, analytic_jvp=True,
                     chunk: int = 256, remat: bool = False, chi=None,
                     nlte: Optional[DeviceNLTE] = None):
    """One batched line sum over the whole (ray x layer) batch (the
    counterpart of the reference's ``layer_tau_pallas``), differentiable
    as ``analytic_jvp`` says (``ops.opacity.ad_mode``):

    - True/'fwd': forward mode (``ops.opacity.LineSumOp``: under
      ``torch.func.jacfwd`` one K1 and one K2 call for the whole Jacobian);
    - 'rev': reverse mode (one K1 call, and one K5 call per gradient, or
      per ``torch.func.jacrev`` while the folded rows fit one call);
    - False: plain autograd through the plain line sum in ``chunk``-line
      slabs on any device (``ops.opacity.line_sum_plain_ad``; ``remat``
      recomputes each slab in the backward pass), with the evaluator of
      ``engine.variant``.  ``windows`` is not used.

    ``nu_off``: the grid in offset coordinates (nu - lines.nu_ref), staged
    from float64 by the caller.  The kernel inputs are cast to its dtype.
    ``engine``: ``ops.cuda_basis.KERNELS`` (the kernels on CUDA tensors),
    ``PLAIN`` (their plain versions) or ``WEIDEMAN`` (the plain versions
    with the Weideman evaluator, on any device).  ``windows``: the scene's window table
    (``ops.cuda_opacity.line_windows`` of ``nu_off`` and ``lines.nu0``).
    ``chi`` = (``ops.chi.ChiProfile``, row_mask): the sub-Lorentzian wing
    correction, valid to a cutoff of ``ops.chi.CHI_MAX_CUTOFF``.
    ``nlte``: the non-LTE state (``data.nlte.DeviceNLTE``), or None for
    LTE.  Returns (dtau, dtau_em), each [R, NL, P].  The prologue and the
    line sum run in the spans ``spectrobot.forward.prologue`` and
    ``spectrobot.forward.line_sum`` (``utils.profiling.annotate``).
    """
    if chi is not None and (cutoff_cm1 is None
                            or cutoff_cm1 > CHI_MAX_CUTOFF):
        raise ValueError(
            f"the chi wing correction implements the first Perrin-Hartmann "
            f"segment only (valid to {CHI_MAX_CUTOFF} cm^-1); "
            f"compute.cutoff_cm1={cutoff_cm1} exceeds it: lower the cutoff "
            f"or disable lines.chi")
    R, NL, _ = cg.u.shape
    dt = nu_off.dtype
    with annotate("spectrobot.forward.prologue"):
        nu_c, sx, y, amps, chi_b = (
            None if a is None else a.to(dt).contiguous()
            for a in _tau_prologue(lines, cg, nlte, chi))
    mode = ad_mode(analytic_jvp)
    with annotate("spectrobot.forward.line_sum"):
        if mode is None:
            out = line_sum_plain_ad(nu_off, nu_c, sx, y, amps, chi_b,
                                    chunk=chunk, cutoff_cm1=cutoff_cm1,
                                    remat=remat, variant=engine.variant)
        else:
            out = LineSumOp(engine, windows, cutoff_cm1, mode)(
                nu_off, nu_c, sx, y, amps, chi_b)      # [B, 2, P]
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


def tau_radiance_epilogue(nu_grid, cg: PathCG, dtau, dtau_em, cia=None,
                          I_background: Optional[torch.Tensor] = None,
                          is_limb: bool = True,
                          emissivity: float = 1.0) -> torch.Tensor:
    """Radiance from line-sum depths [R, NL, P]: add the collision-induced
    continuum ``cia`` (``ops.cia.DeviceCIA``, on the same grid) to both
    depths, assemble sources, and for a nadir path over a grey surface
    (``is_limb=False``, ``I_background`` = eps B(T_s)) add the Lambertian
    reflected downwelling.  Pointwise in (ray, nu): the single-device tails
    and the mesh bodies share it."""
    dtau, dtau_em = add_cia(cia, cg, dtau, dtau_em)
    optics = optics_from_tau(nu_grid, cg, dtau, dtau_em)
    if not is_limb and emissivity < 1.0:
        I_background = I_background + (1.0 - emissivity) * \
            downwelling_radiance(optics, cg)
    return path_radiance(optics, cg, I_background)


def add_cia(cia, cg: PathCG, dtau, dtau_em):
    """(dtau, dtau_em) with the continuum of ``cia`` added to both (both
    unchanged when ``cia`` is None)."""
    if cia is None:
        return dtau, dtau_em
    dc = cia_dtau(cia, cg).to(dtau.dtype)
    return dtau + dc, dtau_em + dc


def radiance_from_tau(nu_grid, cg: PathCG, dtau, dtau_em, cia=None,
                      T_surface=None, emissivity: float = 1.0,
                      I_background: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """RT epilogue: limb when ``T_surface`` is None (deep space or
    ``I_background`` behind), nadir over a grey surface otherwise; ``cia``
    as :func:`tau_radiance_epilogue` takes it."""
    if T_surface is None:
        return tau_radiance_epilogue(nu_grid, cg, dtau, dtau_em, cia=cia,
                                     I_background=I_background)
    I_bg = emissivity * planck_nu(nu_grid, T_surface)
    I_bg = torch.broadcast_to(I_bg, (dtau.shape[0], nu_grid.shape[0]))
    return tau_radiance_epilogue(nu_grid, cg, dtau, dtau_em, cia=cia,
                                 I_background=I_bg, is_limb=False,
                                 emissivity=emissivity)


def _depths(nu_grid, lines: DeviceLines, cg: PathCG, *,
            nu_off: Optional[torch.Tensor] = None, windows=None,
            cutoff_cm1: Optional[float] = 25.0, analytic_jvp=True, **kw):
    """(dtau, dtau_em) of the public entry points: ``nu_off`` defaults to
    ``nu_grid - lines.nu_ref`` and ``windows`` to the table of ``nu_off``
    and ``lines.nu0`` (built on the host; pass the scene's to avoid it)."""
    if nu_off is None:
        nu_off = nu_grid - float(lines.nu_ref)
    if windows is None and ad_mode(analytic_jvp) is not None:
        windows = line_windows(nu_off, lines.nu0, cutoff_cm1=cutoff_cm1)
    return layer_tau_kernel(nu_off, lines, cg, windows,
                            cutoff_cm1=cutoff_cm1, analytic_jvp=analytic_jvp,
                            **kw)


def layer_optics(nu_grid, lines: DeviceLines, cg: PathCG,
                 nlte: Optional[DeviceNLTE] = None, cia=None,
                 **kw) -> LayerOptics:
    """Per-(ray, layer) optical depth and source spectra [R, NL, P] (the
    reference's ``layer_optics``): ``nlte`` weights the line sum, ``cia``
    adds the continuum to both depths before the sources.  Keywords: those
    of :func:`layer_tau_kernel` (``analytic_jvp``, ``engine``,
    ``cutoff_cm1``, ``chunk``, ``remat``, ``chi``) and ``nu_off``,
    ``windows`` (defaults from the grid and the lines)."""
    dtau, dtau_em = add_cia(cia, cg,
                            *_depths(nu_grid, lines, cg, nlte=nlte, **kw))
    return optics_from_tau(nu_grid.to(dtau.dtype), cg, dtau, dtau_em)


def limb_radiance(nu_grid, lines: DeviceLines, cg: PathCG,
                  nlte: Optional[DeviceNLTE] = None, cia=None,
                  **kw) -> torch.Tensor:
    """Limb scan radiances [R, P], deep space behind (the reference's
    ``limb_radiance``).  Keywords as :func:`layer_optics`."""
    dtau, dtau_em = _depths(nu_grid, lines, cg, nlte=nlte, **kw)
    return radiance_from_tau(nu_grid.to(dtau.dtype), cg, dtau, dtau_em,
                             cia=cia)


def nadir_radiance(nu_grid, lines: DeviceLines, cg: PathCG, T_surface,
                   emissivity: float = 1.0,
                   nlte: Optional[DeviceNLTE] = None, cia=None,
                   **kw) -> torch.Tensor:
    """Nadir radiances [R, P] over a grey surface at ``T_surface``, with the
    reflected downwelling for emissivity < 1 (the reference's
    ``nadir_radiance``).  Keywords as :func:`layer_optics`."""
    dtau, dtau_em = _depths(nu_grid, lines, cg, nlte=nlte, **kw)
    return radiance_from_tau(nu_grid.to(dtau.dtype), cg, dtau, dtau_em,
                             cia=cia, T_surface=T_surface,
                             emissivity=emissivity)
