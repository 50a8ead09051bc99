"""The sharded OE/LM retrieval (port of ``spectrobot_tpu.parallel.oe``).

The forward runs on the (ray, line, nu) mesh (:mod:`.sharded`); its
Jacobian is ``torch.func.jacfwd`` of the sharded forward, through the
differentiable collectives (:mod:`.collectives`): one K1 and one K2 call
per line source and rank, every column folded into K2's rows.  The LM
normal equations are assembled on the ranks with one all-reduce per row
axis (:func:`.retrieval.sharded_normal_equations`), and the full Jacobian
is gathered only for the posterior diagnostics
(:func:`.retrieval.allgather_jacobian`).

The host-side LM loop stays ``retrieval.oe.retrieve`` (float64), fed
through its ``normal_eqs`` hook.  Every rank runs it on the same numbers
(the callables here return global, identical results on every rank), so
every rank makes the same collective calls.

The row axes: the instrument function (ILS) mixes the fine grid, so with
an ILS each rank sums its chunk's share of every channel, ``W[:, P_loc] @
I_loc``, and one all-reduce over ``nu`` completes it; every nu rank then
holds the same rows, and the normal equations sum over ``ray`` alone.
Without an ILS the rows are (ray, grid point) tiles and sum over both.
The field of view (FOV) mixes the sharded rays the same way: each rank
smears its block of the fine ray ladder, ``V[:, R_loc] @ I_loc``, and one
all-reduce over ``ray`` completes the observed rays, which drops ``ray``
from the row axes.

With a (P, T) table (``lut=``) the forward interpolates the table on each
rank's ``nu`` chunk and ray block (:mod:`.sharded_lut`); no line sum and
no line-axis collective runs, and the rest (FOV, ILS, the normal
equations) is the same.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from spectrobot_tpu_torch.data.atmosphere import Atmosphere, Planet
from spectrobot_tpu_torch.forward.geometry import limb_path_cg, nadir_path_cg
from spectrobot_tpu_torch.ops.cuda_basis import KERNELS
from spectrobot_tpu_torch.ops.ils import apply_fov, apply_ils
from spectrobot_tpu_torch.ops.lut import NLTELUT
from spectrobot_tpu_torch.ops.opacity import Engine
from spectrobot_tpu_torch.ops.planck import planck_nu
from spectrobot_tpu_torch.ops.strengths import DeviceLines
from spectrobot_tpu_torch.parallel.collectives import psum
from spectrobot_tpu_torch.parallel.retrieval import (
    allgather_jacobian, sharded_normal_equations)
from spectrobot_tpu_torch.parallel.sharded import (
    local_cia, local_lines, pad_lines_for_mesh, partition_lines_by_nu,
    sharded_radiance_fn)
from spectrobot_tpu_torch.parallel.sharded_lut import (
    sharded_lut_radiance_fn, stage_lut_sharded)
from spectrobot_tpu_torch.retrieval.state import (
    apply_state, flatten_state, release_jacobian_graphs)


class ShardedOE:
    """The callables that drive the distributed LM loop, each returning the
    same global result on every rank:

    forward_flat(x) -> y           the flat measurement vector [n_y]
    normal_eqs(x)   -> (F, H, g)   F = forward, H = K^T Se^-1 K,
                                   g = K^T Se^-1 (y - F) (float64)
    jacobian(x)     -> K           the full [n_y, n_x]
    """

    def __init__(self, model, mesh, n_x: int, row_axes, tile, rows):
        self._model = model
        self.mesh = mesh
        self.n_x = n_x
        self.row_axes = row_axes
        self._tile = tile          # (R_loc, C_loc): this rank's row tile
        self._rows = rows          # its rows' indices into the global y
        self._y = self._inv_se = None

    def _jac_local(self, x):
        """(K_loc, F_loc): one jvp of the sharded forward per column, all
        columns in one ``torch.func.jacfwd``, eagerly, after the
        single-card Jacobians' graphs are released (their pools would sit
        beside its tangents)."""
        release_jacobian_graphs()

        def value_twice(v):
            y = self._model(v)
            return y, y
        return torch.func.jacfwd(value_twice, has_aux=True)(x)

    def _gather(self, A):
        return allgather_jacobian(self.mesh, A, self._tile, self.row_axes)

    def forward_flat(self, x) -> torch.Tensor:
        return self._gather(self._model(x)[:, None])[:, 0]

    def jacobian(self, x) -> torch.Tensor:
        return self._gather(self._jac_local(x)[0])

    def bind_observation(self, y, noise_sigma) -> None:
        """Fix (y, S_eps^-1) [n_y] (host arrays, the same on every rank) so
        that ``normal_eqs`` takes x alone, as ``retrieve``'s hook does; each
        rank keeps its own rows, in float64 on its device."""
        dev = self.mesh.device
        rows = lambda a: torch.as_tensor(
            np.asarray(a, np.float64).reshape(-1)[self._rows], device=dev)
        self._y = rows(y)
        self._inv_se = 1.0 / rows(noise_sigma) ** 2

    def normal_eqs(self, x):
        if self._y is None:
            raise RuntimeError("call bind_observation(y, sigma) first")
        K, F = self._jac_local(x)
        H, g = sharded_normal_equations(self.mesh, K, self._y - F,
                                        self._inv_se, self.row_axes)
        return self._gather(F[:, None])[:, 0], H, g


def make_sharded_oe(
    mesh,
    base_atm: Atmosphere,
    lines: DeviceLines,
    nu_grid: torch.Tensor,
    species: Sequence[str],
    planet: Planet,
    tangent_heights_m: Optional[torch.Tensor] = None,
    *,
    state_template: Dict,
    ils_W: Optional[torch.Tensor] = None,
    fov_V: Optional[torch.Tensor] = None,
    nlte=None,
    n_sub: int = 4,
    cutoff_cm1: Optional[float] = 25.0,
    nu_off: Optional[torch.Tensor] = None,
    engine: Engine = KERNELS,
    nu_halo: bool = False,
    sec_theta: Optional[torch.Tensor] = None,
    T_surface=None,
    emissivity: float = 1.0,
    lut=None,
    state_map=None,
    chi=None,
    cia=None,
) -> ShardedOE:
    """The sharded retrieval callables of a limb scene (``tangent_heights_m``
    [R]) or a nadir one (``sec_theta`` [R], surface at ``T_surface`` or the
    state's "T_surface"), for this rank of ``mesh``.

    ``state_template``: the state (flattened as
    ``retrieval.state.flatten_state`` does), the same on every rank;
    ``state_map``: a node -> level expansion applied first
    (``retrieval.state.NodeBasis.expand``).  Every input is the GLOBAL
    array on this rank's device; each rank takes its block.  The ray count
    must split over ``ray``, the grid over ``nu``; the line axis is padded
    (or, with ``nu_halo``, owner-partitioned) here.  ``engine``: the line
    sum's kernels (``ops.cuda_basis.KERNELS``), ``PLAIN`` or ``WEIDEMAN``.
    ``chi`` =
    (``ops.chi.ChiProfile``, row_mask): the sub-Lorentzian wing correction
    (each rank's lines compute their own slopes).  ``nlte``
    (``data.nlte.DeviceNLTE``, replicated) and ``cia``
    (``ops.cia.DeviceCIA`` on the global grid; each rank takes its ``nu``
    block) as ``retrieval.state.build_forward`` takes them.  ``fov_V``
    [n_obs, R] smears the limb rays (the fine ladder
    ``tangent_heights_m``, sharded over ``ray``) into the observed ones.
    ``lut`` (``ops.lut.OpacityLUT``, or ``NLTELUT`` with ``nlte``) runs
    the forward through the table runtime (``parallel.sharded_lut``): the
    tables cut over ``nu``, each call table lookups instead of line sums;
    ``lines``, ``engine``, ``nu_halo`` and ``chi`` are then not used.
    """
    is_limb = tangent_heights_m is not None
    if not is_limb and sec_theta is None:
        raise ValueError("pass tangent_heights_m (limb) or sec_theta (nadir)")
    x0, unravel = flatten_state(state_template)
    n_x = int(x0.shape[0])

    P = nu_grid.shape[0]
    rays = tangent_heights_m if is_limb else sec_theta
    R = rays.shape[0]
    nb, rb = mesh.block(P, "nu"), mesh.block(R, "ray")
    nu_loc = nu_grid[nb]
    rays_loc = rays[rb]
    if lut is not None:
        if isinstance(lut, NLTELUT) != (nlte is not None):
            raise ValueError("pass nlte together with an NLTELUT (and only "
                             "then)")
        lut_loc = stage_lut_sharded(mesh, lut)
        fwd_lut = sharded_lut_radiance_fn(is_limb=is_limb,
                                          emissivity=emissivity)

        def radiance(cg, bg, cia):
            return fwd_lut(lut_loc, cg, nlte=nlte, I_bg=bg, cia=cia)
    else:
        nu_host = nu_grid.detach().cpu().double().numpy()
        if nu_off is None:
            nu_off = torch.as_tensor(nu_host - float(lines.nu_ref),
                                     dtype=nu_grid.dtype,
                                     device=nu_grid.device)
        dlp = (partition_lines_by_nu(lines, nu_host, mesh.shape["nu"],
                                     cutoff_cm1=cutoff_cm1,
                                     line_shards=mesh.shape["line"])
               if nu_halo else pad_lines_for_mesh(lines, mesh.shape["line"]))
        fwd = sharded_radiance_fn(
            mesh, win_grid=nu_off.detach().cpu().double().numpy(),
            win_lines=dlp.nu0.detach().cpu().double().numpy(),
            cutoff_cm1=cutoff_cm1, engine=engine, nu_halo=nu_halo,
            is_limb=is_limb, emissivity=emissivity, chi=chi)
        nu_off_loc = nu_off[nb]
        lines_loc = local_lines(mesh, dlp)

        def radiance(cg, bg, cia):
            return fwd(nu_loc, nu_off_loc, lines_loc, cg, I_bg=bg,
                       nlte=nlte, cia=cia)
    W_loc = None if ils_W is None else ils_W[:, nb]
    V_loc = None if fov_V is None else fov_V[:, rb]
    cia_loc = local_cia(mesh, cia, P)

    def model(x):
        state = unravel(x)
        if state_map is not None:
            state = state_map(state)
        atm = apply_state(base_atm, state)
        if is_limb:
            cg = limb_path_cg(atm, species, rays_loc, planet, n_sub)
            bg = None
        else:
            cg = nadir_path_cg(atm, species, rays_loc, n_sub)
            bg = emissivity * planck_nu(
                nu_loc, state.get("T_surface", T_surface))
        I = radiance(cg, bg, cia_loc)                         # [R_loc, P_loc]
        if V_loc is not None:
            # The FOV mixes the sharded rays: this block's share of every
            # observed ray, summed over the ray ranks.
            I = psum(apply_fov(I, V_loc), mesh, "ray")
        if W_loc is not None:
            # The ILS mixes the sharded grid: this chunk's share of every
            # channel, summed over the nu ranks.
            I = psum(apply_ils(I, W_loc), mesh, "nu")
        return I.reshape(-1)

    # The rows each rank holds: its (ray, column) tile of the [R, C]
    # measurement grid, columns the channels (replicated over nu) or its
    # grid chunk, rows the observed rays (replicated over ray under the
    # FOV) or its block of rays.  The row axes are the axes still sharded.
    row_axes = tuple(ax for ax, mixed in (("ray", fov_V is not None),
                                          ("nu", ils_W is not None))
                     if not mixed)
    R_obs = R if fov_V is None else fov_V.shape[0]
    C = P if ils_W is None else ils_W.shape[0]
    ob = rb if fov_V is None else slice(0, R_obs)
    cb = nb if ils_W is None else slice(0, C)
    rows = np.arange(R_obs * C).reshape(R_obs, C)[ob, cb].reshape(-1)
    tile = (ob.stop - ob.start, cb.stop - cb.start)
    return ShardedOE(model, mesh, n_x, row_axes, tile, rows)
