"""(P, T) opacity look-up tables (port of ``spectrobot_tpu.ops.lut``).

A table holds absorption cross sections on a (T, log10 p) lattice, built
once by the line sum and interpolated bilinearly afterwards: a forward, a
Jacobian or an LM iteration through a table runs no line sum at all.  Two
tiers:

* :class:`OpacityLUT` -- the LTE tier, one sigma table per species row.
* :class:`NLTELUT` -- the non-LTE tier: per-level-group coefficient tables
  (A_l, A_u, M) that the runtime contracts with the current population
  ratios r (the reference module's docstring has the algebra):

      k_abs(nu) = sum_g r_g [A_l,g - A_u,g],   k_em(nu) = sum_g r_g M_g

The build.  Every lattice point is one thermodynamic state, and its table
rows are amplitude rows of one line sum over the whole list: the species
masks (LTE), or the 3G rows (A_l, A_u, M) of the groups (non-LTE).  That
is exactly the batched line sum K1 computes, two amplitude rows a state,
so a build pairs the rows into K1 states and makes one ``engine.accumulate``
call (``ops.cuda_basis.KERNELS``: K1 on the card, its plain version on CPU
tensors; with ``variant="weideman"`` ``WEIDEMAN``, the plain version with
the Weideman evaluator on any device), or one per block of whole T rows
when the states grow large.
The reference builds through its plain XLA line sum (``accumulate_jnp``);
the function is the same.  A table needs no gradient, so the build takes
no derivative route.  With a process group (:func:`lut_mesh`) each rank
builds its contiguous share of the flattened lattice and the shares are
all-gathered (the reference's sharded lattice build).

The runtime is plain tensor arithmetic, as in the reference: gathers of
the four corner rows of each state's lattice cell and one contraction
against differentiable coefficients (corner weights x column x ratio).
The contraction is :class:`RowContract`, whose vmap rule keeps the
tangents of ``torch.func.jacfwd`` off the gathered rows: a Jacobian never
holds a copy of the rows per column.

Clamps: a state outside the lattice is clamped to its edge cells as in the
reference (the fractional index clipped to [0, n - 1.000001]).  At a state
exactly on the lower edge (T = T_min or p = p_min) the reference's clip
passes half of the state's tangent (JAX's derivative of ``maximum`` at a
tie), the port's clamp passes all of it (the cell's one-sided derivative);
everywhere else, on interior nodes too, the two agree.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from spectrobot_tpu_torch.constants import C2
from spectrobot_tpu_torch.ops.cuda_opacity import (
    all_block_windows, line_windows)
from spectrobot_tpu_torch.ops.opacity import (
    Engine, engine_of, line_kernel_inputs)
from spectrobot_tpu_torch.ops.strengths import DeviceLines

# The most states one build call takes (K1's grid limit), and the most
# elements of its [B, 2, P] output (512 MB in float32).
MAX_STATES = 65535
MAX_OUTPUT = 1 << 27


class OpacityLUT(NamedTuple):
    nu_grid: torch.Tensor     # [P]
    T_grid: torch.Tensor      # [nT] (uniform)
    logp_grid: torch.Tensor   # [nQ] log10(p/Pa) (uniform)
    sigma: torch.Tensor       # [S, nT, nQ, P] cm^2/molec
    vmr_self: torch.Tensor    # [S] self-broadening VMR frozen at build


class NLTELUT(NamedTuple):
    """Per-level-group (T, log p) coefficient tables.  Groups 0..S-1 are
    the per-species LTE groups (lines matched to no level,
    ``group_level == -1``); groups S.. are the registry's vibrational
    levels in order."""

    nu_grid: torch.Tensor        # [P]
    T_grid: torch.Tensor         # [nT] (uniform)
    logp_grid: torch.Tensor      # [nQ] log10(p/Pa) (uniform)
    sigma_l: torch.Tensor        # [G, nT, nQ, P]  A_l: coefficient of r_lower
    sigma_u: torch.Tensor        # [G, nT, nQ, P]  A_u: coefficient of -r_upper
    sigma_e: torch.Tensor        # [G, nT, nQ, P]  M: emission, of r_upper
    group_species: torch.Tensor  # [G] int64 species row (-1 = unused level)
    group_level: torch.Tensor    # [G] int64 registry level (-1 = LTE group)
    vmr_self: torch.Tensor       # [S] self-broadening VMR frozen at build

    @property
    def n_groups(self) -> int:
        return int(self.group_species.shape[0])


# ---------------------------------------------------------------------------
# The build
# ---------------------------------------------------------------------------


def lut_mesh():
    """The process group a lattice build is shared over: the default group
    when ``torch.distributed`` is initialized (every rank of the run), else
    None (the serial build)."""
    return dist.group.WORLD if dist.is_initialized() else None


def _lattice(nu_grid, T_min, T_max, n_T, p_min, p_max, n_p):
    """(T_grid [nT], logp_grid [nQ]) in ``nu_grid``'s dtype and device,
    spaced in float64 on the host."""
    on = lambda a: torch.as_tensor(a, dtype=nu_grid.dtype,
                                   device=nu_grid.device)
    return (on(np.linspace(T_min, T_max, n_T)),
            on(np.linspace(np.log10(p_min), np.log10(p_max), n_p)))


def _lattice_eval(points: Callable, T_grid, logp_grid, mesh,
                  per_point: int) -> torch.Tensor:
    """``points(T [n], logp [n]) -> [n, ...]`` over the (nT, nQ) lattice,
    in calls of at most ``per_point``-sized budgets (whole T rows where one
    fits) -> [nT, nQ, ...].

    ``mesh`` (a process group, :func:`lut_mesh`): the flattened lattice,
    padded with copies of the first node to a multiple of the group's
    size, is cut into contiguous shares; each rank evaluates its own and
    the shares are all-gathered; the pad points are dropped."""
    nT, nQ = T_grid.shape[0], logp_grid.shape[0]
    Tf = T_grid.repeat_interleave(nQ)
    Qf = logp_grid.repeat(nT)
    n_pts = nT * nQ
    if mesh is not None:
        world, rank = dist.get_world_size(mesh), dist.get_rank(mesh)
        n_pad = -n_pts % world
        Tf = torch.cat([Tf, T_grid[:1].expand(n_pad)])
        Qf = torch.cat([Qf, logp_grid[:1].expand(n_pad)])
        share = (n_pts + n_pad) // world
        Tf = Tf[rank * share:(rank + 1) * share]
        Qf = Qf[rank * share:(rank + 1) * share]
    step = per_point if per_point < nQ else (per_point // nQ) * nQ
    out = torch.cat([points(Tf[s:s + step], Qf[s:s + step])
                     for s in range(0, Tf.shape[0], step)])
    if mesh is not None:
        parts = [torch.empty_like(out) for _ in range(world)]
        dist.all_gather(parts, out.contiguous(), group=mesh)
        out = torch.cat(parts)[:n_pts]
    return out.reshape((nT, nQ) + out.shape[1:])


def _staged_grid(nu_grid, lines: DeviceLines, cutoff_cm1, nu_off=None):
    """The grid in offset coordinates (``nu_off``, else ``nu_grid`` minus
    the lines' origin in float64) and its window table (every line block
    per tile if the centers are not sorted)."""
    if nu_off is None:
        nu_off = torch.as_tensor(
            nu_grid.detach().cpu().double().numpy() - float(lines.nu_ref),
            dtype=nu_grid.dtype, device=nu_grid.device)
    nu0 = lines.nu0.detach().cpu().numpy()
    if np.all(np.diff(nu0) >= 0):
        windows = line_windows(nu_off, nu0, cutoff_cm1=cutoff_cm1)
    else:
        windows = all_block_windows(nu_off, len(nu0), cutoff_cm1=cutoff_cm1)
    return nu_off, windows


def _rows_per_state(n_rows: int) -> int:
    """K1 states a lattice point takes: its rows paired into K1's two."""
    return (n_rows + 1) // 2


def _points_per_call(n_rows: int, n_points: int) -> int:
    J = _rows_per_state(n_rows)
    return max(1, min(MAX_STATES // J,
                      MAX_OUTPUT // (2 * J * max(n_points, 1))))


def _line_sums(nu_off, windows, lines: DeviceLines, T, p, p_self_line,
               weights, *, engine: Engine, cutoff_cm1, chi):
    """The line sums of the amplitude rows ``weights(T)`` ([n or 1, R, L]
    per-line weights) at the n lattice states (T, p) [n], through one
    ``engine.accumulate`` call: the rows of each state paired into K1's
    two (a zero row completes an odd count) -> [n, R, P].  ``p_self_line``
    [L]: each line's self-broadening pressure over p."""
    n, L = T.shape[0], lines.n_lines
    Tl = T[:, None].expand(n, L)
    pl = p[:, None].expand(n, L)
    kl = line_kernel_inputs(lines, Tl, pl, p_self_line * pl, None, chi=chi)
    amps = weights(T) * kl.amps                         # [n, R, L]
    R = amps.shape[1]
    J = _rows_per_state(R)
    if 2 * J != R:
        amps = torch.cat([amps, torch.zeros_like(amps[:, :1])], dim=1)
    rep = lambda a: (None if a is None else
                     a[:, None, :].expand(n, J, L).reshape(n * J, L)
                     .contiguous())
    out = engine.accumulate(nu_off, windows, rep(kl.nu_c), rep(kl.scale_x),
                            rep(kl.y), amps.reshape(n * J, 2, L).contiguous(),
                            cutoff_cm1=cutoff_cm1, chi_b=rep(kl.chi_b))
    return out.reshape(n, 2 * J, -1)[:, :R]


def build_lut(
    nu_grid: torch.Tensor,
    lines: DeviceLines,
    n_species: int,
    T_min: float = 120.0, T_max: float = 320.0, n_T: int = 21,
    p_min: float = 1e-3, p_max: float = 2e3, n_p: int = 25,
    vmr_self: Optional[Sequence[float]] = None,
    *,
    variant: str = "humlicek4",
    cutoff_cm1: Optional[float] = 25.0,
    chunk: int = 256,
    mesh=None,
    chi=None,
    engine: Optional[Engine] = None,
    nu_off: Optional[torch.Tensor] = None,
) -> OpacityLUT:
    """The LTE table of the line list on ``nu_grid`` over the (T, log10 p)
    lattice: sigma[s] at each node is the line sum of the lines of species
    row s (self-broadened at ``vmr_self[s]`` x p), through
    ``engine.accumulate`` with two species rows a K1 state.  ``chi`` =
    (``ops.chi.ChiProfile``, row_mask): the wing correction, baked into the
    table (its slope follows the lattice T).  ``variant``: the evaluator
    of Re w; ``engine`` defaults to its engine
    (``ops.cuda_basis.engine_for``: K1 for humlicek4, the plain versions
    with the Weideman evaluator for weideman, as the reference builds that
    variant through its XLA line sum), and one of another variant raises a
    ValueError.  ``mesh``: a process group
    (:func:`lut_mesh`) to share the build over its ranks.  ``nu_off``: the
    grid in offset coordinates staged from float64 (``nu_grid - nu_ref``
    otherwise; a float32 ``nu_grid`` is rounded to ~3e-5 cm-1 near 650
    cm-1, a tenth of a Doppler width aloft, and the reference's float32
    tables carry that error).  ``chunk`` is the reference's slab size,
    kept for the cache key (the line sums here choose their own)."""
    engine = engine_of(variant, engine)
    S = n_species
    vs = np.ones(S) if vmr_self is None else np.asarray(vmr_self, float)
    dt, dev = nu_grid.dtype, nu_grid.device
    T_grid, logp_grid = _lattice(nu_grid, T_min, T_max, n_T, p_min, p_max,
                                 n_p)
    nu_off, windows = _staged_grid(nu_grid, lines, cutoff_cm1, nu_off)
    vs_line = torch.as_tensor(vs, dtype=dt, device=dev)[lines.species_idx]
    masks = (lines.species_idx[None, None, :] == torch.arange(
        S, device=dev)[None, :, None]).to(dt)           # [1, S, L]

    def points(T, logp):
        return _line_sums(nu_off, windows, lines, T, 10.0 ** logp, vs_line,
                          lambda _: masks, engine=engine,
                          cutoff_cm1=cutoff_cm1, chi=chi)

    tbl = _lattice_eval(points, T_grid, logp_grid, mesh,
                        _points_per_call(S, nu_grid.shape[0]))
    return OpacityLUT(nu_grid=nu_grid, T_grid=T_grid, logp_grid=logp_grid,
                      sigma=tbl.permute(2, 0, 1, 3).contiguous(),
                      vmr_self=torch.as_tensor(vs, dtype=dt, device=dev))


def _line_groups(lines: DeviceLines, n_species: int):
    """Host-side group assignment: the lower and upper group of each line,
    and the group -> species and group -> level maps (int64 arrays)."""
    S = n_species
    sp = lines.species_idx.cpu().numpy()
    lu = lines.level_upper.cpu().numpy()
    lo = lines.level_lower.cpu().numpy()
    n_levels = int(max(lu.max(initial=-1), lo.max(initial=-1)) + 1)
    G = S + n_levels
    lower_group = np.where(lo >= 0, S + lo, sp).astype(np.int64)
    upper_group = np.where(lu >= 0, S + lu, sp).astype(np.int64)
    group_species = np.full(G, -1, dtype=np.int64)
    group_species[:S] = np.arange(S)
    group_species[upper_group[lu >= 0]] = sp[lu >= 0]
    group_species[lower_group[lo >= 0]] = sp[lo >= 0]
    group_level = np.concatenate([np.full(S, -1, dtype=np.int64),
                                  np.arange(n_levels, dtype=np.int64)])
    return lower_group, upper_group, group_species, group_level


def build_nlte_lut(
    nu_grid: torch.Tensor,
    lines: DeviceLines,
    n_species: int,
    T_min: float = 120.0, T_max: float = 320.0, n_T: int = 21,
    p_min: float = 1e-3, p_max: float = 2e3, n_p: int = 25,
    vmr_self: Optional[Sequence[float]] = None,
    *,
    variant: str = "humlicek4",
    cutoff_cm1: Optional[float] = 25.0,
    chunk: int = 256,
    mesh=None,
    chi=None,
    engine: Optional[Engine] = None,
    nu_off: Optional[torch.Tensor] = None,
) -> NLTELUT:
    """The three per-group tables in one line sum per lattice point: the
    3G amplitude rows (A_l, A_u, M) of every group share the line-shape
    work, paired into K1 states (``engine.accumulate``).  E = exp(-c2
    nu0 / T) uses the absolute centers, as the reference does.  Arguments
    as :func:`build_lut`."""
    engine = engine_of(variant, engine)
    S = n_species
    vs = np.ones(S) if vmr_self is None else np.asarray(vmr_self, float)
    dt, dev = nu_grid.dtype, nu_grid.device
    T_grid, logp_grid = _lattice(nu_grid, T_min, T_max, n_T, p_min, p_max,
                                 n_p)
    nu_off, windows = _staged_grid(nu_grid, lines, cutoff_cm1, nu_off)
    lower_g, upper_g, group_species, group_level = _line_groups(lines, S)
    G = int(group_level.shape[0])
    onehot = lambda g: torch.as_tensor(g[None, :] == np.arange(G)[:, None],
                                       dtype=dt, device=dev)
    mask_l, mask_u = onehot(lower_g), onehot(upper_g)   # [G, L]
    vs_line = torch.as_tensor(vs, dtype=dt, device=dev)[lines.species_idx]
    nu0_abs = lines.nu0_abs.to(dt)

    def weights(T):
        E = torch.exp(-C2 * nu0_abs[None, :] / T[:, None])   # [n, L]
        inv1mE = 1.0 / (1.0 - E)
        return torch.cat([mask_l * inv1mE[:, None, :],
                          mask_u * (E * inv1mE)[:, None, :],
                          mask_u.expand(T.shape[0], G, -1)], dim=1)

    def points(T, logp):
        return _line_sums(nu_off, windows, lines, T, 10.0 ** logp, vs_line,
                          weights, engine=engine, cutoff_cm1=cutoff_cm1,
                          chi=chi)

    tbl = _lattice_eval(points, T_grid, logp_grid, mesh,
                        _points_per_call(3 * G, nu_grid.shape[0]))
    nT, nQ = T_grid.shape[0], logp_grid.shape[0]
    tbl = tbl.reshape(nT, nQ, 3, G, -1).permute(2, 3, 0, 1, 4).contiguous()
    idx = lambda a: torch.as_tensor(a, device=dev)
    return NLTELUT(nu_grid=nu_grid, T_grid=T_grid, logp_grid=logp_grid,
                   sigma_l=tbl[0], sigma_u=tbl[1], sigma_e=tbl[2],
                   group_species=idx(group_species),
                   group_level=idx(group_level),
                   vmr_self=torch.as_tensor(vs, dtype=dt, device=dev))


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------


def _corners(T_grid, logp_grid, T, p_pa):
    """The bilinear cell of each state (T, p_pa, broadcast together): flat
    lattice indices it * nQ + iq of its corners (00, 01, 10, 11) [..., 4]
    and their weights [..., 4], differentiable in (T, p)."""
    nT, nQ = T_grid.shape[0], logp_grid.shape[0]
    ft = (T - T_grid[0]) / (T_grid[1] - T_grid[0])
    fq = ((torch.log10(p_pa) - logp_grid[0])
          / (logp_grid[1] - logp_grid[0]))
    ft, fq = torch.broadcast_tensors(torch.clamp(ft, 0.0, nT - 1.000001),
                                     torch.clamp(fq, 0.0, nQ - 1.000001))
    it = torch.floor(ft).to(torch.int64)
    iq = torch.floor(fq).to(torch.int64)
    at, aq = ft - it, fq - iq
    base = it * nQ + iq
    idx = torch.stack([base, base + 1, base + nQ, base + nQ + 1], dim=-1)
    w = torch.stack([(1 - at) * (1 - aq), (1 - at) * aq, at * (1 - aq),
                     at * aq], dim=-1)
    return idx, w


def _bilinear_tq(tbl: torch.Tensor, T_grid, logp_grid, T, p_pa
                 ) -> torch.Tensor:
    """Bilinear interpolation of ``tbl[..., nT, nQ, P]`` in (T, log10 p) at
    a state (scalars or tensors) -> [..., P] (a state's own dimensions
    between those and P).  Differentiable; clamps to the table's edge."""
    on = lambda v: torch.as_tensor(v, dtype=tbl.dtype, device=tbl.device)
    idx, w = _corners(T_grid, logp_grid, on(T), on(p_pa))
    rows = tbl.reshape(tbl.shape[:-3] + (-1, tbl.shape[-1]))[..., idx, :]
    w = w.to(tbl.dtype)[..., None]
    return (w[..., 0, :] * rows[..., 0, :] + w[..., 1, :] * rows[..., 1, :]
            + w[..., 2, :] * rows[..., 2, :] + w[..., 3, :] * rows[..., 3, :])


def interp_sigma(lut: OpacityLUT, T, p_pa) -> torch.Tensor:
    """Bilinear interpolation in (T, log10 p) -> sigma [S, P]."""
    return _bilinear_tq(lut.sigma, lut.T_grid, lut.logp_grid, T, p_pa)


class RowContract(torch.autograd.Function):
    """out[..., p] = sum_k c[..., k] rows[..., k, p], differentiable in c
    (``rows`` holds table rows: constants).  Its vmap rule contracts a
    batch of coefficient vectors (``torch.func.jacfwd``'s tangents) against
    the one copy of the rows, [..., T, K] @ [..., K, P]; broadcasting the
    rows over the batch would copy them once per column."""

    @staticmethod
    def forward(c, rows):
        return torch.matmul(c.unsqueeze(-2), rows).squeeze(-2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, rows = inputs
        ctx.save_for_backward(rows)
        ctx.save_for_forward(rows)

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        return torch.matmul(rows, g.unsqueeze(-1)).squeeze(-1), None

    @staticmethod
    def jvp(ctx, dc, _drows):
        (rows,) = ctx.saved_tensors
        return RowContract.apply(dc, rows)

    @staticmethod
    def vmap(info, in_dims, c, rows):
        c_dim, rows_dim = in_dims
        if rows_dim is not None:
            rows = rows.movedim(rows_dim, 0)
            c = (c.unsqueeze(0).expand((info.batch_size,) + c.shape)
                 if c_dim is None else c.movedim(c_dim, 0))
            return RowContract.apply(c, rows), 0
        c = c.movedim(c_dim, -2)                      # [..., T, K]
        return torch.matmul(c, rows), c.dim() - 2


def _contract(coef, rows):
    """Sum over the corner (and species or group) rows: coef [R, NL, K]
    (cast to the table's dtype), rows [R, NL, K, P] -> [R, NL, P]."""
    return RowContract.apply(coef.to(rows.dtype), rows)


def _group_rows(tbl, idx):
    """tbl [X, nT, nQ, P], per-state corner indices [R, NL, X, 4] into
    each X's own lattice -> the rows [R, NL, X*4, P]."""
    X, nT, nQ, P = tbl.shape
    off = torch.arange(X, device=idx.device)[:, None] * (nT * nQ)
    rows = tbl.reshape(X * nT * nQ, P)[(idx + off).flatten(-2)]
    return rows


def layer_tau_lut(lut: OpacityLUT, cg) -> torch.Tensor:
    """LTE per-(ray, layer) optical depth from the table: dtau [R, NL, P]
    (dtau_em == dtau in LTE), each species row at its own Curtis-Godson
    state."""
    idx, w = _corners(lut.T_grid, lut.logp_grid, cg.T_sp, cg.p_sp)
    coef = w * (cg.u * 1.0e-4)[..., None]             # [R, NL, S, 4]
    return _contract(coef.flatten(-2), _group_rows(lut.sigma, idx))


def nlte_group_ratios(lut: NLTELUT, nlte, lay_idx, T_kin) -> torch.Tensor:
    """Population ratios r [..., G]: 1 for the LTE groups, the Boltzmann
    ratio of ``data.nlte`` for level groups.  ``lay_idx``: a layer index
    (or a tensor of them) and ``T_kin`` its kinetic temperature (or
    temperatures broadcasting against them)."""
    gl = lut.group_level
    if nlte is None:
        return torch.ones(gl.shape, dtype=lut.sigma_l.dtype,
                          device=gl.device)
    tv = nlte.t_vib[:, lay_idx].movedim(0, -1)          # [..., n_levels]
    T_kin = torch.as_tensor(T_kin, dtype=tv.dtype, device=tv.device)
    r_lvl = torch.exp(-C2 * nlte.e_level
                      * (1.0 / tv - 1.0 / T_kin[..., None]))
    return torch.where(gl >= 0, r_lvl[..., gl.clamp(min=0)], 1.0)


def table_depths(lut, cg, nlte=None):
    """(dtau, dtau_em) [R, NL, P] through either tier:
    :func:`layer_tau_nlte_lut` for an :class:`NLTELUT` (with the
    populations ``nlte``), else :func:`layer_tau_lut` (the same depth
    twice, as in LTE)."""
    if isinstance(lut, NLTELUT):
        return layer_tau_nlte_lut(lut, cg, nlte)
    dtau = layer_tau_lut(lut, cg)
    return dtau, dtau


def layer_tau_nlte_lut(lut: NLTELUT, cg, nlte=None):
    """Non-LTE per-(ray, layer) optical depths from the tables: (dtau,
    dtau_em), each [R, NL, P], as ``forward.limb.layer_tau_kernel`` gives
    them.  Each group interpolates at its species' Curtis-Godson state and
    contracts against u[species] r[group]; differentiable in ``cg`` and in
    ``nlte.t_vib``."""
    R, NL, S = cg.u.shape
    gs = lut.group_species.clamp(min=0)
    lay = torch.arange(NL, device=cg.u.device)
    r = nlte_group_ratios(lut, nlte, lay, cg.T_air).to(cg.u.dtype)
    idx, w = _corners(lut.T_grid, lut.logp_grid, cg.T_sp[..., gs],
                      cg.p_sp[..., gs])                # [R, NL, G, 4]
    coef = (w * (cg.u[..., gs] * 1.0e-4 * r)[..., None]).flatten(-2)
    rows_l = _group_rows(lut.sigma_l, idx)
    rows_a = rows_l - _group_rows(lut.sigma_u, idx)
    del rows_l
    dtau = _contract(coef, rows_a)
    del rows_a
    return dtau, _contract(coef, _group_rows(lut.sigma_e, idx))


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------

_FINGERPRINT_FIELDS = ("nu0", "sw", "elower", "gamma_air", "gamma_self",
                       "n_air", "delta_air", "mass_amu", "species_idx",
                       "level_upper", "level_lower", "nu_ref")


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a))


def _content(v):
    """A lattice parameter as plain numbers, so its repr depends on its
    content only (a tensor's repr names its device and elides long ones)."""
    if isinstance(v, (torch.Tensor, np.ndarray)):
        v = _host(v).tolist()
    if isinstance(v, (tuple, list)):
        return tuple(_content(x) for x in v)
    return v


def lut_fingerprint(nu_grid, lines: DeviceLines, nu_off=None,
                    **lattice) -> str:
    """Content hash keying a persisted table to its inputs: the staged line
    list, the grid (and its offset coordinates ``nu_off``, if given) and
    every lattice and build parameter (``chi`` by its numbers), so a stale
    file misses the cache.  The reference's recipe,
    on the port's staged arrays: its index arrays are int64, so a
    fingerprint of the port does not equal the JAX package's for the same
    inputs (a table of either loads in both, :func:`load_lut`)."""
    h = hashlib.sha256()
    for f in _FINGERPRINT_FIELDS:
        h.update(_host(getattr(lines, f)).tobytes())
    h.update(_host(nu_grid).tobytes())
    if nu_off is not None:
        h.update(_host(nu_off).tobytes())
    for k in sorted(lattice):
        h.update(f"{k}={_content(lattice[k])!r};".encode())
    return h.hexdigest()


def _save(path: str, arrays: dict) -> None:
    """Write the .npz whole or not at all (a rename), so that a rank that
    reads it while another writes never sees half a file."""
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def save_lut(lut: OpacityLUT, path: str, fingerprint: str = "") -> None:
    """The reference's .npz layout (the same keys and arrays)."""
    _save(path, {**{f: _host(getattr(lut, f)) for f in OpacityLUT._fields},
                 "fingerprint": np.asarray(fingerprint)})


def load_lut(path: str, *, device) -> OpacityLUT:
    with np.load(path) as z:
        return OpacityLUT(**{f: torch.as_tensor(z[f], device=device)
                             for f in OpacityLUT._fields})


def save_nlte_lut(lut: NLTELUT, path: str, fingerprint: str = "") -> None:
    """The reference's .npz layout (group maps as int32)."""
    arrays = {f: _host(getattr(lut, f)) for f in NLTELUT._fields}
    for f in ("group_species", "group_level"):
        arrays[f] = arrays[f].astype(np.int32)
    _save(path, {"fingerprint": np.asarray(fingerprint), **arrays})


def load_nlte_lut(path: str, *, device) -> NLTELUT:
    with np.load(path) as z:
        arrays = {f: z[f] for f in NLTELUT._fields}
    for f in ("group_species", "group_level"):
        arrays[f] = arrays[f].astype(np.int64)
    return NLTELUT(**{f: torch.as_tensor(a, device=device)
                      for f, a in arrays.items()})


def stored_fingerprint(path: str) -> str:
    """The fingerprint recorded in a persisted table ('' if none)."""
    if not os.path.exists(path):
        return ""
    with np.load(path) as z:
        return str(z["fingerprint"]) if "fingerprint" in z.files else ""


def get_or_build_lut(path: str, nu_grid, lines: DeviceLines, n_species: int,
                     *, nlte: bool = False, mesh=None, **lattice):
    """The table at ``path`` if its fingerprint matches these inputs, else
    one built (:func:`build_lut`, or :func:`build_nlte_lut` with ``nlte``)
    and persisted; ``path=''`` builds in memory.  Under a process group
    only rank 0 writes.  Returns (lut, was_cached)."""
    fp = lut_fingerprint(nu_grid, lines, nlte=nlte, **lattice)
    dev = nu_grid.device
    if path and stored_fingerprint(path) == fp:
        return ((load_nlte_lut(path, device=dev) if nlte
                 else load_lut(path, device=dev)), True)
    build, save = ((build_nlte_lut, save_nlte_lut) if nlte
                   else (build_lut, save_lut))
    lut = build(nu_grid, lines, n_species, mesh=mesh, **lattice)
    if path and (not dist.is_initialized() or dist.get_rank() == 0):
        save(lut, path, fingerprint=fp)
    return lut, False
