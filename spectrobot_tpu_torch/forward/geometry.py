"""Line-of-sight geometry + Curtis-Godson averaging (port of
``spectrobot_tpu.forward.geometry``).

Closed-form chord lengths through spherical shells,

    l(r) = sqrt(max(r^2 - r_t^2, 0)),   ds_layer = l(r_top) - l(r_bot),

evaluated for all rays at once (the reference's vmap over rays is the
leading ray dimension here); layers below the tangent point get ds = 0.
Curtis-Godson averages use ``n_sub`` equal-path-length samples per layer
crossing.  Everything is computed on the atmosphere's device, the segment
order included: no host copy, so a CUDA graph can capture the path.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from spectrobot_tpu_torch.data.atmosphere import Atmosphere, Planet


class PathCG(NamedTuple):
    """Curtis-Godson description of a batch of rays through a layered
    atmosphere.  R = n_rays, NL = n_layers (= n_lev - 1), S = n_species."""

    u: torch.Tensor            # [R, NL, S] one-side species column [m^-2]
    T_sp: torch.Tensor         # [R, NL, S] CG temperature per species [K]
    p_sp: torch.Tensor         # [R, NL, S] CG pressure per species [Pa]
    p_self_sp: torch.Tensor    # [R, NL, S] CG species partial pressure [Pa]
    T_air: torch.Tensor        # [R, NL] air-density-weighted CG temperature
    seg_layer: torch.Tensor    # [n_seg] int64, observer-first layer index
    seg_count: int             # number of segments
    is_limb: bool              # limb (2 crossings/layer) vs nadir (1)
    u_air: torch.Tensor = None   # [R, NL] one-side AIR column [m^-2]
    uu_air: torch.Tensor = None  # [R, NL] int n_air^2 ds, SCALED by UU_SCALE


# Exact power-of-two scale carried by PathCG.uu_air ((2^-83)^2 at the sample
# level keeps (n * 2^-83)^2 ~ O(1) in float32).
UU_SCALE = 2.0 ** -166


def _layer_samples_limb(z_lev, r_t, radius, n_sub):
    """Quadrature points and path-length weights [m] of every one-side
    layer crossing: z_lev [n_lev], r_t [R] -> (z_k, w) [R, NL, n_sub]."""
    r_lev = radius + z_lev
    l_lev = torch.sqrt(torch.clamp(r_lev ** 2 - r_t[:, None] ** 2, min=0.0))
    l_bot = l_lev[:, :-1]
    dl = l_lev[:, 1:] - l_bot                                   # [R, NL]
    k = (torch.arange(n_sub, dtype=z_lev.dtype, device=z_lev.device)
         + 0.5) / n_sub
    l_k = l_bot[..., None] + dl[..., None] * k
    z_k = torch.sqrt(r_t[:, None, None] ** 2 + l_k ** 2) - radius
    w = torch.broadcast_to((dl / n_sub)[..., None], l_k.shape)
    return z_k, w


def _layer_samples_nadir(z_lev, sec_theta, n_sub):
    """Quadrature points/weights of nadir rays with zenith-angle secants
    sec_theta [R] -> (z_k, w) [R, NL, n_sub]."""
    z_bot = z_lev[:-1]
    dz = z_lev[1:] - z_bot
    k = (torch.arange(n_sub, dtype=z_lev.dtype, device=z_lev.device)
         + 0.5) / n_sub
    z_k = torch.broadcast_to(z_bot[:, None] + dz[:, None] * k,
                             (sec_theta.shape[0],) + dz.shape + (n_sub,))
    w = torch.broadcast_to((dz * sec_theta[:, None] / n_sub)[..., None],
                           z_k.shape)
    return z_k, w


def _cg_from_samples(atm: Atmosphere, species: Sequence[str], z_k, w):
    """Curtis-Godson sums over the quadrature samples [..., n_sub].
    Returns (u, T_sp, p_sp, p_self_sp, T_air, u_air, uu_air), species last.
    """
    T = atm.interp_T(z_k)
    p = atm.interp_logp(z_k)
    n = atm.interp_n(z_k)

    # float32-safe weighted averages: the averaging weights carry an exact
    # power-of-two scale (2^-83 ~ 1e-25, ratios unchanged bit-for-bit) so
    # forward-mode tangents of the divisions, which square the divisor, stay
    # in range; and empty layers (below the tangent) divide by 1 through
    # where(ok, u, 1) -> divide -> where(ok, value, default), never by 0.
    CG_SCALE = 2.0 ** -83
    w_s = w * CG_SCALE
    n_air_col = torch.sum(n * w_s, dim=-1)
    air_ok = n_air_col > 0
    T_air = torch.sum(T * n * w_s, dim=-1) / torch.where(air_ok, n_air_col,
                                                         1.0)
    T_air = torch.where(air_ok, T_air, 200.0)
    u_air = n_air_col * (1.0 / CG_SCALE)
    n_s = n * CG_SCALE
    uu_air = torch.sum(n_s * n_s * w, dim=-1)          # x UU_SCALE

    us, Ts, ps, pss, oks = [], [], [], [], []
    for name in species:
        vmr = atm.interp_vmr(name, z_k)
        ns = n * vmr
        u_s = torch.sum(ns * w_s, dim=-1)
        ok = u_s > 0
        u_div = torch.where(ok, u_s, 1.0)
        Ts.append(torch.sum(T * ns * w_s, dim=-1) / u_div)
        ps.append(torch.sum(p * ns * w_s, dim=-1) / u_div)
        pss.append(torch.sum(p * vmr * ns * w_s, dim=-1) / u_div)
        us.append(u_s * (1.0 / CG_SCALE))
        oks.append(ok)
    stack = lambda xs: torch.stack(xs, dim=-1)
    ok = stack(oks)
    T_sp = torch.where(ok, stack(Ts), 200.0)
    p_sp = torch.where(ok, stack(ps), 1.0)
    p_self_sp = torch.where(ok, stack(pss), 0.0)
    return stack(us), T_sp, p_sp, p_self_sp, T_air, u_air, uu_air


def limb_path_cg(atm: Atmosphere, species: Sequence[str],
                 tangent_heights_m: torch.Tensor, planet: Planet,
                 n_sub: int = 4) -> PathCG:
    """CG description of limb rays at the given tangent heights [R].

    Segment order (observer-first): near-side crossings top layer -> layer
    0, then far-side crossings layer 0 -> top layer.
    """
    n_lay = atm.n_lev - 1
    radius = planet.radius_m
    z_k, w = _layer_samples_limb(atm.z, radius + tangent_heights_m, radius,
                                 n_sub)
    u, T_sp, p_sp, p_self_sp, T_air, u_air, uu_air = _cg_from_samples(
        atm, species, z_k, w)
    up = torch.arange(n_lay, device=atm.z.device)
    return PathCG(
        u=u, T_sp=T_sp, p_sp=p_sp, p_self_sp=p_self_sp, T_air=T_air,
        seg_layer=torch.cat([up.flip(0), up]),
        seg_count=2 * n_lay, is_limb=True, u_air=u_air, uu_air=uu_air)


def nadir_path_cg(atm: Atmosphere, species: Sequence[str],
                  sec_theta: torch.Tensor, n_sub: int = 4) -> PathCG:
    """CG description of nadir rays; ``sec_theta`` [R] is the secant of each
    ray's viewing zenith angle.  Segment order: top layer -> layer 0."""
    n_lay = atm.n_lev - 1
    z_k, w = _layer_samples_nadir(atm.z, sec_theta, n_sub)
    u, T_sp, p_sp, p_self_sp, T_air, u_air, uu_air = _cg_from_samples(
        atm, species, z_k, w)
    return PathCG(
        u=u, T_sp=T_sp, p_sp=p_sp, p_self_sp=p_self_sp, T_air=T_air,
        seg_layer=torch.arange(n_lay - 1, -1, -1, device=atm.z.device),
        seg_count=n_lay, is_limb=False, u_air=u_air, uu_air=uu_air)
