"""Command-line entry point of the port:

    python -m spectrobot_tpu_torch forward  cfg.toml [-o section.key=value ...]
                                               [--device {cuda,cpu}]
    python -m spectrobot_tpu_torch retrieve cfg.toml [...]
    python -m spectrobot_tpu_torch info
    torchrun --nproc_per_node=N -m spectrobot_tpu_torch {forward,retrieve}
        cfg.toml -o compute.mesh_nu=N [--device {cuda,cpu}]

It reads the reference's TOML schema (the port's copy of its
``config`` module, :mod:`spectrobot_tpu_torch.config`) and writes
``run.output_dir/forward.npz``, or ``retrieval.npz`` and ``run.jsonl``, in
the reference's layout.  The forward is the single-device line-by-line
limb/nadir path, in local thermodynamic equilibrium or with prescribed
vibrational populations (``[nlte]``), with the collision-induced continuum
(``[cia]``) and the field of view (``instrument.fov_fwhm_km``: a fine ray
ladder smeared into the observed rays), over a 1-D atmosphere or a 2-D
climatology sliced at ``scene.latitude_deg``; ``retrieve`` fits it to
observations with forward-mode Jacobians and the Levenberg-Marquardt
optimal-estimation loop.  With ``compute.use_lut`` both run through a
(P, T) table of the scene's cross sections (``ops.lut``), built once
through K1 (or loaded from ``compute.lut_path``) and interpolated per
call.  With ``compute.mesh_ray/line/nu`` set to a mesh
of more than one rank, both run on the (ray, line, nu) mesh over the ranks
``torchrun`` starts (:mod:`spectrobot_tpu_torch.parallel`: NCCL, one card
per rank, or gloo on the CPU), and rank 0 writes the outputs.  With
``run.save_optics`` the single-device line-by-line forward also writes
``optics.npz``: each ray's line-of-sight optical depth and transmittance,
from the same line sum as the radiances.

Engine rule (:func:`select_engine`), the reference's ``_engine`` policy
with the card in the TPU's place: with ``compute.variant = "humlicek4"``
and ``compute.use_pallas = true`` the opacity line sum runs in the CUDA
kernels on CUDA (K1 for the primal, K2 for the Jacobian, K5 for a
gradient; ``ops.cuda_basis.KERNELS``), which compute in float32: with
``compute.dtype = "float64"`` the pipeline stays float64 and hands them
float32 copies of its inputs, as the reference runs its float32 kernels
under x64.  With ``compute.use_pallas = false`` it runs in the kernels'
plain PyTorch versions on the card (``ops.cuda_basis.PLAIN``, in the
configured dtype), the counterpart of the reference's XLA engine.  On the
CPU humlicek4 takes ``KERNELS``, whose wrappers run their plain versions
in the configured dtype (the reference's XLA engine off the TPU).  With
``compute.variant = "weideman"`` it runs in plain PyTorch on either device,
in the configured dtype (``ops.cuda_basis.WEIDEMAN``), as the reference
runs that variant only on its XLA engine: no kernel evaluates it.  The
engine taken is named in the log.  ``--device cuda``
without a GPU raises; nothing falls back to the CPU, and no engine gives
way to another when a kernel fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from spectrobot_tpu_torch.config import Config, load_config
from spectrobot_tpu_torch.data import atmosphere as atm_mod
from spectrobot_tpu_torch.data.lines import configured_lines
from spectrobot_tpu_torch.ops.cuda_basis import (
    KERNELS, PLAIN, WEIDEMAN, engine_for)
from spectrobot_tpu_torch.ops.cuda_opacity import Windows, line_windows
from spectrobot_tpu_torch.ops.ils import fov_matrix, ils_matrix
from spectrobot_tpu_torch.ops.opacity import Engine
from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist
from spectrobot_tpu_torch.parallel.mesh import (
    finalize_multihost, initialize_multihost, make_mesh)
from spectrobot_tpu_torch.parallel.oe import ShardedOE, make_sharded_oe
from spectrobot_tpu_torch.retrieval.state import (
    NodeBasis, build_forward, build_forward_lut, flatten_state,
    jacobian_fwd, jacobian_fwd_chunked, jacobian_graphed, make_state)
from spectrobot_tpu_torch.spectra import optical_depth as optical_depth_spectrum
from spectrobot_tpu_torch.spectra import radiance as radiance_spectrum


def select_engine(cfg, device: torch.device) -> Engine:
    """The engine rule, the reference's ``_engine`` with the card in the
    TPU's place: "weideman" takes ``WEIDEMAN`` (plain PyTorch on either
    device, in the configured dtype); "humlicek4" takes ``KERNELS`` on the
    card when ``compute.use_pallas`` is set, in either dtype (the kernels
    compute in float32, a float64 pipeline casting their inputs and
    results), and ``PLAIN`` there when it is not (the reference's XLA
    engine); on the CPU ``KERNELS``, whose wrappers send CPU tensors to the
    plain versions in any dtype.  Any other variant raises a
    ValueError."""
    if cfg.compute.variant != "humlicek4":
        return engine_for(cfg.compute.variant)
    if device.type != "cpu" and not cfg.compute.use_pallas:
        return PLAIN
    return KERNELS


def _build_atmosphere(cfg, device):
    """(planet, the 1-D atmosphere): a built-in profile, or a .npz; a 2-D
    climatology ("mars_zonal", or a .npz with lat_deg) sliced at
    scene.latitude_deg."""
    planet = atm_mod.PLANETS[cfg.scene.planet.lower()]
    src = cfg.scene.atmosphere
    size = dict(n_lev=cfg.scene.n_levels, z_top=cfg.scene.z_top_m,
                device=device)
    if src == "mars_standard":
        atm = atm_mod.mars_standard_atmosphere(**size)
    elif src == "titan_standard":
        atm = atm_mod.titan_standard_atmosphere(**size)
    elif src == "mars_zonal":
        atm = atm_mod.mars_zonal_atmosphere(**size)
    else:
        with np.load(src) as z:
            is_2d = "lat_deg" in z.files
        atm = (atm_mod.Atmosphere2D if is_2d else atm_mod.Atmosphere
               ).load_npz(src, device=device)
    if isinstance(atm, atm_mod.Atmosphere2D):
        atm = atm.at_lat(cfg.scene.latitude_deg)
    return planet, atm


# The counters of the scene built last (build_scene): the limb rays the
# forward runs under the field of view (0 without one), and the lines whose
# upper or lower level the [nlte] section pumps, a t_vib apart from the
# kinetic profile in some layer (0 in LTE).
SCENE_COUNTS = {"fov_fine_rays": 0, "nlte_pumped_lines": 0}


def _build_nlte(cfg, ll, atm, dtype, device):
    """Non-LTE state from config (reference call stack 4.4): registry from
    the line list's quanta, t_vib per the ``[nlte]`` section, matched level
    indices annotated IN PLACE on ``ll``, so this runs before the lines are
    staged on the device.  Counts the pumped lines (``SCENE_COUNTS``)."""
    from spectrobot_tpu_torch.data.nlte import (
        demo_pump_t_vib, device_nlte, lte_t_vib, match_lines_to_levels,
        registry_from_linelist, t_vib_from_npz)

    reg = registry_from_linelist(ll)
    if reg.n_levels == 0:
        raise ValueError("[nlte] enabled but the line list carries no "
                         "global quanta to match levels from")
    match_lines_to_levels(ll, reg)
    z_lev = atm.z.cpu().numpy()
    z_mid = 0.5 * (z_lev[1:] + z_lev[:-1])
    T_lay = np.interp(z_mid, z_lev, atm.T.cpu().numpy())
    src = cfg.nlte.t_vib
    if not src:
        t_vib = lte_t_vib(reg, T_lay)
    elif src.startswith("demo:"):
        if src != "demo:co2_pump":
            raise KeyError(f"unknown nlte demo {src!r} (have demo:co2_pump)")
        t_vib = demo_pump_t_vib(reg, z_mid, T_lay)
    else:
        t_vib = t_vib_from_npz(reg, src, z_mid, T_lay)
    # An unmatched line's index, -1, reads the False appended last.
    pumped = np.append((t_vib != lte_t_vib(reg, T_lay)).any(axis=1), False)
    SCENE_COUNTS["nlte_pumped_lines"] = int(
        (pumped[ll.level_upper] | pumped[ll.level_lower]).sum())
    return device_nlte(reg, t_vib, dtype=dtype, device=device)


def _build_cia(cfg, nu, species_names, dtype, device):
    """[cia] config -> the staged continuum on ``nu`` (or None if no pair
    applies)."""
    from spectrobot_tpu_torch.ops.cia import (
        demo_co2_cia, parse_cia_text, stage_cia)

    tables = []
    for entry in cfg.cia.tables or ("demo:co2",):
        if entry == "demo:co2":
            tables.append(demo_co2_cia())
            continue
        pair, _, path = entry.partition(":")
        a, _, b = pair.partition("-")
        if not (a and b and path):
            raise ValueError(f"cia.tables entry {entry!r} is neither "
                             f"'demo:co2' nor 'A-B:<path>.cia'")
        with open(path) as f:
            tables.append(parse_cia_text(f.read(), a, b))
    staged = stage_cia(nu, tables, species_names, dtype=dtype, device=device)
    if staged is None:
        import warnings
        warnings.warn("cia.enabled is set but no table matches the scene "
                      "species: the continuum is off for this run")
    return staged


def _build_fov(cfg, dtype, device):
    """The limb rays and the FOV smearing: (tangent heights [m] of the rays
    the forward runs, fov_V or None).  With ``instrument.fov_fwhm_km > 0``
    the forward runs on a fine ladder of ``instrument.fov_n_fine`` rays
    spanning the observed tangent heights +- 2 FWHM, and fov_V [n_obs,
    n_fine] smears the ladder into the observed fields of view."""
    h_obs_km = np.asarray(cfg.geometry.tangent_heights_km, float)
    fwhm_km = cfg.instrument.fov_fwhm_km
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    if fwhm_km <= 0:
        return t(h_obs_km * 1e3), None
    lo = max(float(h_obs_km.min()) - 2.0 * fwhm_km, 0.0)
    hi = float(h_obs_km.max()) + 2.0 * fwhm_km
    h_fine_km = np.linspace(lo, hi, cfg.instrument.fov_n_fine)
    V = fov_matrix(h_fine_km * 1e3, h_obs_km * 1e3, fwhm_km * 1e3,
                   cfg.instrument.fov_shape)
    return t(h_fine_km * 1e3), t(V)


def _build_chi(cfg, species_names):
    """[lines] chi -> (ChiProfile, per-species-row apply mask) or None."""
    name = cfg.lines.chi
    if not name:
        return None
    from spectrobot_tpu_torch.ops.chi import CHI_PROFILES
    if name not in CHI_PROFILES:
        raise KeyError(f"unknown lines.chi profile {name!r}; available: "
                       f"{sorted(CHI_PROFILES)}")
    prof = CHI_PROFILES[name]
    mask = tuple(s.upper() == prof.species.upper() for s in species_names)
    if not any(mask):
        import warnings
        warnings.warn(f"lines.chi = {name!r} applies to {prof.species} but "
                      f"the scene species are {species_names}: chi is a "
                      f"no-op for this run")
    return (prof, mask)


@dataclasses.dataclass(frozen=True, eq=False)
class Scene:
    """The configured scene on its device (:func:`build_scene`).  Compared
    and hashed by identity, and held weakly by the retrieval problems built
    on it (:func:`retrieval_problem`), which go with it."""
    planet: atm_mod.Planet
    atm: atm_mod.Atmosphere
    lines: object              # DeviceLines
    species_names: list
    nu: torch.Tensor           # [P] grid, compute dtype
    nu_off: torch.Tensor       # [P] grid - lines.nu_ref, staged from f64
    W: object                  # [n_chan, P] ILS matrix or None
    chans: np.ndarray          # output axis (channels, or the fine grid)
    windows: Windows           # the kernels' window table, built once
    chi: object                # (ChiProfile, row mask) or None (lines.chi)
    nlte: object               # DeviceNLTE or None ([nlte])
    cia: object                # DeviceCIA or None ([cia])
    h_t: object                # [R] limb rays [m] (the fine ladder under
                               # the FOV), or None (nadir)
    fov_V: object              # [n_obs, R] FOV matrix or None
    lut: object = None         # the (P, T) table (compute.use_lut) or None
    lut_src: str = ""          # where the table came from


def build_scene(cfg, device: torch.device) -> Scene:
    """Config -> the forward's inputs on ``device``; sets
    ``SCENE_COUNTS``."""
    from spectrobot_tpu_torch.data.molparams import MOLECULES, molecule_by_name

    dtype = torch.float64 if cfg.compute.dtype == "float64" else torch.float32
    SCENE_COUNTS.update(fov_fine_rays=0, nlte_pumped_lines=0)
    planet, atm = _build_atmosphere(cfg, device)
    ll = configured_lines(cfg)
    # The level indices go on the host line list before it is staged.
    nlte = (_build_nlte(cfg, ll, atm, dtype, device) if cfg.nlte.enabled
            else None)
    # One species row per (mol, iso) pair present in the line list.
    present = {(int(m), int(i)) for m, i in zip(ll.mol_id, ll.iso_id)}
    pairs = []
    for name in cfg.scene.species:
        mol = molecule_by_name(name)
        pairs.extend((mol.mol_id, iso) for iso in mol.isotopologues
                     if (mol.mol_id, iso) in present)
        if not any(p[0] == mol.mol_id for p in pairs):
            pairs.append((mol.mol_id, 1))   # keep the row (no lines yet)
    dl = device_lines_from_linelist(ll, pairs, dtype=dtype, device=device)
    species_names = [MOLECULES[m].name for (m, _) in pairs]
    nu_host = np.linspace(cfg.grid.nu_min, cfg.grid.nu_max, cfg.grid.n_points)
    nu = torch.as_tensor(nu_host, dtype=dtype, device=device)
    # Offset grid staged from float64 (float32-precision dnu; DeviceLines).
    nu_off = torch.as_tensor(nu_host - float(dl.nu_ref), dtype=dtype,
                             device=device)
    W, chans = None, nu.cpu().numpy()
    if cfg.instrument.enabled:
        ins = cfg.instrument
        lo = ins.chan_min or cfg.grid.nu_min + 2 * ins.fwhm_cm1
        hi = ins.chan_max or cfg.grid.nu_max - 2 * ins.fwhm_cm1
        chans = np.linspace(lo, hi, ins.n_channels)
        # Built on the compute-dtype grid, as the reference builds it.
        W = torch.as_tensor(ils_matrix(nu.cpu().numpy(), chans, ins.fwhm_cm1,
                                       ins.shape), dtype=dtype, device=device)
    windows = line_windows(nu_off, dl.nu0,
                           cutoff_cm1=cfg.compute.cutoff_cm1)
    cia = (_build_cia(cfg, nu, species_names, dtype, device)
           if cfg.cia.enabled else None)
    h_t, fov_V = (_build_fov(cfg, dtype, device)
                  if cfg.geometry.mode == "limb" else (None, None))
    if fov_V is not None:
        SCENE_COUNTS["fov_fine_rays"] = int(fov_V.shape[1])
    chi = _build_chi(cfg, species_names)
    lut, lut_src = (_get_lut(cfg, nu, nu_off, dl, species_names, atm, nlte,
                             chi) if cfg.compute.use_lut else (None, ""))
    return Scene(planet, atm, dl, species_names, nu, nu_off, W, chans,
                 windows, chi, nlte, cia, h_t, fov_V, lut, lut_src)


def lut_lattice(cfg, atm, species_names, chi, nu_off) -> dict:
    """The table's lattice and build keywords for the scene
    (``ops.lut.build_lut``'s): T spans the atmosphere's (+-30 K), p its
    (x0.5, x2), each species self-broadened at its surface VMR; the grid's
    offset coordinates ``nu_off`` staged from float64, as the line-by-line
    path takes them."""
    c = cfg.compute
    T_arr, p_arr = atm.T.cpu().numpy(), atm.p.cpu().numpy()
    return dict(
        T_min=max(80.0, float(T_arr.min()) - 30.0),
        T_max=float(T_arr.max()) + 30.0, n_T=c.lut_n_T,
        p_min=max(float(p_arr.min()) * 0.5, 1e-6),
        p_max=float(p_arr.max()) * 2.0, n_p=c.lut_n_p,
        vmr_self=[float(atm.vmr[name][0]) for name in species_names],
        variant=c.variant, cutoff_cm1=c.cutoff_cm1, chunk=c.chunk, chi=chi,
        nu_off=nu_off)


def _get_lut(cfg, nu, nu_off, lines, species_names, atm, nlte, chi):
    """The (P, T) table of the scene (:func:`lut_lattice`), built through
    K1, or loaded from compute.lut_path when its fingerprint matches; the
    non-LTE tier with ``nlte``.  With compute.lut_build_mesh and a process
    group, its ranks share the build.  Returns (lut, where it came
    from)."""
    from spectrobot_tpu_torch.ops.lut import get_or_build_lut, lut_mesh

    c = cfg.compute
    mesh = lut_mesh() if c.lut_build_mesh else None
    lut, cached = get_or_build_lut(
        c.lut_path, nu, lines, len(species_names), nlte=nlte is not None,
        mesh=mesh, **lut_lattice(cfg, atm, species_names, chi, nu_off))
    tier = "non-LTE per-level tables" if nlte is not None else "LTE"
    src = ("cached " + c.lut_path if cached else
           f"built on {dist.get_world_size(mesh)} ranks" if mesh is not None
           else "built")
    return lut, f"{tier}, {src}"


def n_rays(cfg) -> int:
    """The observed rays: the rows of the output."""
    g = cfg.geometry
    return len(g.tangent_heights_km if g.mode == "limb" else g.sec_theta)


def n_model_rays(cfg) -> int:
    """The rays the forward runs: the fine ladder under the FOV, else the
    observed rays."""
    if cfg.geometry.mode == "limb" and cfg.instrument.fov_fwhm_km > 0:
        return cfg.instrument.fov_n_fine
    return n_rays(cfg)


def _rays(cfg, scene: Scene) -> dict:
    """The configured rays as ``build_forward`` takes them: tangent heights
    [R] and the FOV matrix (limb), or secants [R] and the surface
    temperature (nadir)."""
    g = cfg.geometry
    if g.mode == "limb":
        return {"tangent_heights_m": scene.h_t, "fov_V": scene.fov_V}
    return {"sec_theta": torch.as_tensor(g.sec_theta, dtype=scene.nu.dtype,
                                         device=scene.nu.device),
            "T_surface": g.t_surface}


def scene_forward(cfg, scene: Scene, atm=None, engine: Engine = KERNELS,
                  analytic_jvp=True, depths_tap=None):
    """F: state -> y (``retrieval.state.build_forward``) of the configured
    rays over ``atm`` (default: the scene's), the line sum on ``engine``,
    differentiable as ``analytic_jvp`` says (True: forward mode, 'rev':
    reverse mode, False: plain autograd); ``depths_tap`` as
    ``build_forward`` takes it.  With the scene's table (compute.use_lut)
    it interpolates the table instead (``build_forward_lut``: no line sum,
    plain autograd in both directions)."""
    g = cfg.geometry
    atm = scene.atm if atm is None else atm
    if scene.lut is not None:
        return build_forward_lut(atm, scene.lut, scene.species_names,
                                 scene.planet, emissivity=g.emissivity,
                                 ils_W=scene.W, nlte=scene.nlte,
                                 n_sub=g.n_sub, cia=scene.cia,
                                 **_rays(cfg, scene))
    return build_forward(atm, scene.lines, scene.nu, scene.species_names,
                         scene.planet, emissivity=g.emissivity,
                         ils_W=scene.W, n_sub=g.n_sub,
                         cutoff_cm1=cfg.compute.cutoff_cm1,
                         nu_off=scene.nu_off, engine=engine,
                         windows=scene.windows, analytic_jvp=analytic_jvp,
                         chi=scene.chi, nlte=scene.nlte, cia=scene.cia,
                         depths_tap=depths_tap, **_rays(cfg, scene))


def sharded_problem(cfg, scene: Scene, mesh, atm, state_template,
                    engine: Engine = KERNELS, state_map=None) -> ShardedOE:
    """The configured forward over ``atm`` on this rank of ``mesh``, with
    its sharded Jacobian and normal equations (``parallel.oe``), the state
    shaped as ``state_template``."""
    g = cfg.geometry
    return make_sharded_oe(
        mesh, atm, scene.lines, scene.nu, scene.species_names, scene.planet,
        state_template=state_template, ils_W=scene.W, n_sub=g.n_sub,
        cutoff_cm1=cfg.compute.cutoff_cm1, nu_off=scene.nu_off,
        engine=engine, nu_halo=cfg.compute.mesh_halo,
        emissivity=g.emissivity, state_map=state_map, chi=scene.chi,
        nlte=scene.nlte, cia=scene.cia, lut=scene.lut, **_rays(cfg, scene))


def run_forward(cfg, scene: Scene, engine: Engine = KERNELS,
                depths_tap=None) -> torch.Tensor:
    """Radiances of the configured rays ([R, n_chan] with the instrument,
    else [R, P]), with the line sum on ``engine``; ``depths_tap(cg, dtau)``
    receives the line sum's layer depths (``build_forward``)."""
    fwd = scene_forward(cfg, scene, engine=engine, depths_tap=depths_tap)
    return fwd(make_state(scene.atm, [], retrieve_temperature=False)
               ).reshape(n_rays(cfg), -1)


def resolve_device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available "
                           "(use --device cpu for the plain version)")
    return torch.device(name)


def _check_mesh_divisibility(cfg, n_rays: int, m_ray: int, m_nu: int) -> None:
    """The mesh's sharded axes must divide what they cut (the rays the
    forward runs, and the grid): a ValueError naming the TOML keys."""
    if n_rays % m_ray != 0:
        raise ValueError(
            f"the ray count ({n_rays}, from geometry.tangent_heights_km / "
            f"geometry.sec_theta, or instrument.fov_n_fine with a field of "
            f"view) must be divisible by compute.mesh_ray ({m_ray}); pad "
            f"the ray list or change compute.mesh_ray")
    if cfg.grid.n_points % m_nu != 0:
        raise ValueError(
            f"grid.n_points ({cfg.grid.n_points}) must be divisible by "
            f"compute.mesh_nu ({m_nu}); adjust grid.n_points or "
            f"compute.mesh_nu")


def mesh_plan(cfg, world_size: int):
    """(use_mesh, (ray, line, nu)) from compute.mesh_*: the mesh engages
    only when the configuration sets an axis (the defaults (1, 1, 0) stay
    single-device) and its shape has more than one rank; mesh_nu = 0 takes
    the ranks that the other two axes leave of ``world_size``."""
    c = cfg.compute
    m_ray, m_line = c.mesh_ray, c.mesh_line
    explicit = (m_ray, m_line, c.mesh_nu) != (1, 1, 0)
    m_nu = c.mesh_nu or max(world_size // max(m_ray * m_line, 1), 1)
    return explicit and m_ray * m_line * m_nu > 1, (m_ray, m_line, m_nu)


@contextlib.contextmanager
def open_mesh(cfg, device: torch.device):
    """The configured mesh over the ranks ``torchrun`` started (its
    WORLD_SIZE), for the life of the ``with`` block, or None for a
    single-device run.  A mesh whose size is not the world's, and a world
    of several ranks with no mesh configured, raise a ValueError: no run
    quietly falls back to one device."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    use_mesh, shape = mesh_plan(cfg, world)
    if not use_mesh:
        if world > 1:
            raise ValueError(
                f"{world} ranks (WORLD_SIZE) but the configuration sets no "
                f"mesh of more than one rank: set compute.mesh_ray, "
                f"compute.mesh_line or compute.mesh_nu (a single-device run "
                f"takes one process)")
        yield None
        return
    n = shape[0] * shape[1] * shape[2]
    if n != world:
        raise ValueError(
            f"compute.mesh_ray, compute.mesh_line, compute.mesh_nu = {shape} "
            f"is a mesh of {n} ranks, but the run has {world} (WORLD_SIZE): "
            f"start it with torchrun --nproc_per_node={n}")
    _check_mesh_divisibility(cfg, n_model_rays(cfg), shape[0], shape[2])
    made = initialize_multihost(device.type)
    try:
        yield make_mesh(shape, device.type)
    finally:
        if made:
            finalize_multihost()


def _is_rank0(mesh) -> bool:
    return mesh is None or dist.get_rank() == 0


def cmd_forward(cfg, device: torch.device) -> dict:
    use_mesh, _ = mesh_plan(cfg, int(os.environ.get("WORLD_SIZE", 1)))
    if cfg.run.save_optics and (use_mesh or cfg.compute.use_lut):
        # The reference's refusal: the optics reuse the single-device
        # line-by-line branch's depths.
        raise ValueError(
            "run.save_optics currently requires the single-device "
            "line-by-line forward — disable compute.mesh_* and "
            "compute.use_lut, or drop run.save_optics")
    with open_mesh(cfg, device) as mesh:
        return _forward(cfg, device, mesh)


def save_optics(cfg, scene: Scene, cg, dtau: torch.Tensor) -> str:
    """Write ``optics.npz`` (the reference's ``run.save_optics``): each
    ray's line-of-sight optical depth [R, P], the segment sum of the layer
    depths ``dtau`` [R, NL, P] (the forward's own line sum, with the
    continuum added when ``[cia]`` is on), as an optical-depth Spectrum on
    the fine grid with its transmittance exp(-tau).  Returns the path."""
    from spectrobot_tpu_torch.ops.cia import cia_dtau

    dtau = dtau.detach()
    if scene.cia is not None:
        dtau = dtau + cia_dtau(scene.cia, cg).to(dtau.dtype)
    tau_los = dtau[:, cg.seg_layer, :].sum(dim=1).cpu().numpy()
    sp = optical_depth_spectrum(scene.nu.cpu().numpy().astype(np.float64),
                                tau_los)
    path = os.path.join(cfg.run.output_dir, "optics.npz")
    os.makedirs(cfg.run.output_dir, exist_ok=True)
    sp.save_npz(path, transmittance=np.exp(-tau_los))
    print(f"optics: LOS tau + transmittance -> {path}", file=sys.stderr)
    return path


def _engine_used(scene: Scene, engine: Engine, device) -> str:
    """What the run's line sums take, for the log: the engine (and its
    cast, ``Engine.describe``), or none through the scene's table."""
    if scene.lut is not None:
        return "none (the table)"
    return engine.describe(scene.nu.dtype, device)


def _forward(cfg, device: torch.device, mesh) -> dict:
    engine = select_engine(cfg, device)
    scene = build_scene(cfg, device)
    used = _engine_used(scene, engine, device)
    halo = cfg.compute.mesh_halo and scene.lut is None
    t0 = time.time()
    if mesh is None:
        taps = []
        tap = ((lambda cg, dtau: taps.append((cg, dtau)))
               if cfg.run.save_optics else None)
        I = run_forward(cfg, scene, engine, depths_tap=tap)
        if taps:
            save_optics(cfg, scene, *taps[0])
    else:
        empty = make_state(scene.atm, [], retrieve_temperature=False)
        oe = sharded_problem(cfg, scene, mesh, scene.atm, empty, engine)
        I = oe.forward_flat(flatten_state(empty)[0]).reshape(n_rays(cfg), -1)
        if _is_rank0(mesh):
            axes = dict(zip(("ray", "line", "nu"), mesh.shape.values()))
            print(f"mesh LUT forward over {axes} ({scene.lut_src})"
                  if scene.lut is not None else
                  f"mesh forward over {axes} engine={used}"
                  f"{' nu-halo' if halo else ''}", file=sys.stderr)
    I = I.cpu().numpy()                 # waits for the device
    wall = time.time() - t0

    out_path = os.path.join(cfg.run.output_dir, "forward.npz")
    where = str(device) if mesh is None else (
        f"a {tuple(mesh.shape.values())} (ray, line, nu) mesh of "
        f"{mesh.size} {device.type} ranks{', nu-halo' if halo else ''}")
    if scene.lut is not None:
        where += f" (LUT runtime: {scene.lut_src})"
    if _is_rank0(mesh):
        os.makedirs(cfg.run.output_dir, exist_ok=True)
        # After ILS channelisation the spectral axis is the channel centers.
        sp = radiance_spectrum(np.asarray(scene.chans, np.float64), I)
        extra = {"tangent_heights_km":
                 np.asarray(cfg.geometry.tangent_heights_km)}
        if scene.W is not None:
            extra["nu_fine"] = scene.nu.cpu().numpy()
        sp.save_npz(out_path, radiance=I, **extra)  # 'radiance' = compat alias
        try:
            from spectrobot_tpu_torch.utils.plots import plot_radiances
            labels = ([f"{h:.1f} km" for h in cfg.geometry.tangent_heights_km]
                      if cfg.geometry.mode == "limb" else
                      [f"sec={s_:.2f}" for s_ in cfg.geometry.sec_theta])
            plot_radiances(os.path.join(cfg.run.output_dir, "forward.png"),
                           np.asarray(sp.nu), np.asarray(sp.values),
                           labels=labels if len(labels) == I.shape[0]
                           else None,
                           title=f"{cfg.geometry.mode} {sp.kind} [{sp.units}]")
        except Exception as e:  # plotting must never fail a forward
            print(f"plotting skipped: {e}", file=sys.stderr)
        print(f"forward: {I.shape} radiances in {wall:.2f}s on {where}, "
              f"engine {used} -> {out_path}", file=sys.stderr)
    return {"radiance_shape": list(I.shape), "wall_s": wall,
            "output": out_path, "n_lines": scene.lines.n_lines,
            "device": where}


def _check_obs_consistency(cfg, obs, chans, n_chan):
    """A loaded observation must match the configured geometry and channel
    grid: a silent mismatch would fit real data with the wrong forward
    model, so every discrepancy names the config key to fix."""
    if cfg.geometry.mode == "limb":
        got = (None if obs.tangent_heights_m is None
               else np.asarray(obs.tangent_heights_m) / 1e3)
        want = np.asarray(cfg.geometry.tangent_heights_km, dtype=float)
        what = "geometry.tangent_heights_km"
    else:
        got = None if obs.sec_theta is None else np.asarray(obs.sec_theta)
        want = np.asarray(cfg.geometry.sec_theta, dtype=float)
        what = "geometry.sec_theta"
    if got is not None and (got.shape != want.shape
                            or not np.allclose(got, want, rtol=1e-6)):
        raise ValueError(
            f"observation file {cfg.retrieval.obs_path!r} has "
            f"{what.split('.')[1]} {np.round(got, 3).tolist()} but the "
            f"config requests {want.tolist()}: set {what} to match the "
            f"file (the forward model is built from the config)")
    if obs.n_chan != n_chan or not np.allclose(
            np.asarray(obs.nu_channels), np.asarray(chans), rtol=0, atol=1e-6):
        raise ValueError(
            f"observation file {cfg.retrieval.obs_path!r} has {obs.n_chan} "
            f"channels on [{float(obs.nu_channels[0]):.3f}, "
            f"{float(obs.nu_channels[-1]):.3f}] cm-1 but the configured "
            f"instrument produces {n_chan} on [{float(chans[0]):.3f}, "
            f"{float(chans[-1]):.3f}]: adjust instrument.n_channels / "
            f"chan_min / chan_max (or grid.*) to match the file")


# The Jacobian's memory guard.  ``torch.func.jacfwd`` carries an n_x-column
# tangent of every (ray, layer, point) array through the forward, and at
# its peak the port holds about JAC_LIVE_TANGENTS such tangent-sized
# buffers (K2's [B, 2 n_x, P] output, the two depths and the vmapped
# epilogue's temporaries).  Measured as (peak - resident memory) over
# n_x x rays x layers x points x the dtype's size (chip_smoke.py phase
# 6k; NVIDIA H100 80GB HBM3 at 700 W): examples/mars_limb.toml 13.33 at
# n_x = 33, 13.17 at 66, 13.65 at 17 levels; config 3 13.33; the composed
# scene (CIA, a FOV over 40 rays) 15.40; the float64 Weideman slice 13.33;
# config 5 13.25 at n_x = 50 and 13.10 at 114; the float64 slice through
# the float32 kernels 13.33, as Weideman's (their float32 copies are freed
# before the epilogue's peak).  Those are the composed epilogue's counts.
# Where the epilogue is the fused kernel (``forward.limb.fused_epilogue``:
# the kernels' engine on the card, forward mode, a limb or a black
# surface), which keeps no temporary of a tangent's size, the same
# Jacobians hold 4.1-4.2 (the composed scene, whose CIA adds to both
# depths, 6.2), so the count is about 2.3-3.4 times theirs there: the
# guard chunks and releases graphs early on that route, never late.
JAC_LIVE_TANGENTS = 14.0
# The CPU's limit: the reference's 8 GB, half of the 16 GB of the v5e it
# was set on (spectrobot_tpu/cli.py:560-564).
JAC_HOST_LIMIT = 8e9
# Columns a chunk once the count passes the limit (the reference's).
JAC_AUTO_CHUNK = 16


def jacobian_bytes(cfg, n_x: int, n_fine: int) -> float:
    """The unchunked Jacobian's counted bytes: JAC_LIVE_TANGENTS tangent
    buffers of n_x x the forward's rays (the fine ladder under a FOV) x
    layers x ``n_fine`` points, in the compute dtype (8 bytes in float64
    on every engine, the kernels' float32 copies included, else 4)."""
    size = 8 if cfg.compute.dtype == "float64" else 4
    return (JAC_LIVE_TANGENTS * size * n_x * n_model_rays(cfg)
            * (cfg.scene.n_levels - 1) * n_fine)


def jacobian_limit(device) -> float:
    """The counted bytes above which the Jacobian is chunked: half of the
    card's memory on a CUDA device, JAC_HOST_LIMIT on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory / 2
    return JAC_HOST_LIMIT


def jacobian_chunk(cfg, n_x: int, n_fine: int, device) -> Optional[int]:
    """The tangent columns a chunk, or None for one ``jacfwd``:
    ``retrieval.jac_chunk`` when it is set, else JAC_AUTO_CHUNK where
    :func:`jacobian_bytes` passes :func:`jacobian_limit`."""
    if cfg.retrieval.jac_chunk:
        return int(cfg.retrieval.jac_chunk)
    if jacobian_bytes(cfg, n_x, n_fine) > jacobian_limit(device):
        return JAC_AUTO_CHUNK
    return None


def make_jacobian(cfg, fwd_flat, n_x: int, n_fine: int, device,
                  graph: bool = True):
    """The Jacobian callable, with the reference's memory guard on the
    port's own bytes: the unchunked ``torch.func.jacfwd``, or
    :func:`jacobian_fwd_chunked` (the same values, a bounded tangent batch)
    in the columns of :func:`jacobian_chunk`; either in one span
    ``spectrobot.jacobian`` a call.  The unchunked one is
    ``retrieval.state.jacobian_graphed`` where ``graph`` is true: on the
    card it replays one CUDA graph of ``fwd_flat``'s Jacobian, captured at
    the first call and shared by every callable made for the same
    ``fwd_flat`` (:func:`retrieval_problem` gives one a scene,
    configuration and engine), its graphs and those of other forwards held
    within :func:`jacobian_limit`; on the CPU it runs eagerly.  On an H100
    a capture costs about 1.7 eager Jacobians and a replay saves about a
    quarter of one, so a graph repays itself only after about seven
    replays: a caller that calls one forward's Jacobian a few times, as
    one retrieval does, passes ``graph=False`` and runs ``jacfwd``
    eagerly.  The chunked one runs eagerly."""
    chunk = jacobian_chunk(cfg, n_x, n_fine, device)
    if chunk:
        print(f"jacobian: chunked forward-mode ({chunk} tangent columns)",
              file=sys.stderr)
        return lambda x: jacobian_fwd_chunked(fwd_flat, x, chunk=chunk)
    if not graph:
        return lambda x: jacobian_fwd(fwd_flat, x)
    return jacobian_graphed(fwd_flat, jacobian_bytes(cfg, n_x, n_fine),
                            jacobian_limit(device))


def _node_basis(cfg, atm):
    """The configured coarse retrieval grid (retrieval.node_alt_km or
    retrieval.n_nodes), or None to retrieve at every model level."""
    r = cfg.retrieval
    if r.node_alt_km:
        # TOML float lists and "-o retrieval.node_alt_km=[a,b]" strings.
        node_km = [float(str(v).strip("[] ")) for v in r.node_alt_km]
        return NodeBasis(atm.z.cpu().numpy(),
                         np.asarray(node_km, np.float64) * 1e3)
    if r.n_nodes:
        if r.n_nodes < 2:
            raise ValueError(
                f"retrieval.n_nodes ({r.n_nodes}) must be >= 2 (or 0 to "
                f"retrieve at every model level)")
        return NodeBasis.uniform(atm, r.n_nodes)
    return None


class RetrievalProblem(NamedTuple):
    atm: atm_mod.Atmosphere    # the prior atmosphere, in the compute dtype
    nb: Optional[NodeBasis]    # the coarse node grid, or None
    init: object               # atmosphere -> state (levels or nodes)
    x0: torch.Tensor           # the flat prior state
    fwd_flat: object           # F: flat state -> y [n_ray * n_chan]


# The retrieval problems built on each live scene, by the configuration's
# value, the engine and the AD mode (retrieval_problem).
_PROBLEMS: "weakref.WeakKeyDictionary[Scene, dict]" = (
    weakref.WeakKeyDictionary())


def retrieval_problem(cfg, scene: Scene, engine: Engine = KERNELS,
                      analytic_jvp=True) -> RetrievalProblem:
    """The configured retrieval's state at the prior and its flat forward
    model, with the line sum on ``engine``, differentiable as
    ``analytic_jvp`` says (True: the Jacobian by ``torch.func.jacfwd``,
    'rev': the gradient of a cost by ``torch.autograd.grad``).  The scene's
    atmosphere is cast to the compute dtype (the line sum and its
    derivatives run in K1, K2 and K5 on the card, in float32 in either
    dtype: ``KERNELS`` casts a float64 pipeline's inputs and results).

    Built once for a scene, a configuration (by value), an engine and an
    AD mode, and kept while the scene lives: a later call gives the same
    flat forward (so :func:`make_jacobian` replays the CUDA graph that the
    first call's Jacobian captured) and a copy of x0."""
    built = _PROBLEMS.setdefault(scene, {})
    # The engine by identity: the problem's forward holds it, so the id
    # stays its own while the entry lives.
    key = (repr(cfg), id(engine), analytic_jvp)
    if key not in built:
        built[key] = _retrieval_problem(cfg, scene, engine, analytic_jvp)
    prob = built[key]
    return prob._replace(x0=prob.x0.clone())


def _retrieval_problem(cfg, scene: Scene, engine: Engine,
                       analytic_jvp) -> RetrievalProblem:
    atm = scene.atm.to(scene.nu.dtype)
    retrieve_vmr = list(cfg.retrieval.retrieve_vmr)
    ret_T = cfg.retrieval.retrieve_temperature
    if not ret_T and not retrieve_vmr:
        raise ValueError("nothing to retrieve: enable "
                         "retrieval.retrieve_temperature or list species in "
                         "retrieval.retrieve_vmr")
    nb = _node_basis(cfg, atm)
    if nb is None:
        init = lambda a: make_state(a, retrieve_vmr,
                                    retrieve_temperature=ret_T)
        expand = lambda s: s
    else:
        init = lambda a: nb.init_state(a, retrieve_vmr,
                                       retrieve_temperature=ret_T)
        expand = nb.expand
    x0, unravel = flatten_state(init(atm))
    fwd = scene_forward(cfg, scene, atm, engine, analytic_jvp)
    return RetrievalProblem(atm, nb, init, x0,
                            lambda x: fwd(expand(unravel(x))))


def cmd_retrieve(cfg, device: torch.device) -> dict:
    """Fit the configured forward to observations: ``retrieval.obs_path``,
    else a self-test truth that perturbs every retrieved quantity.  Writes
    retrieval.npz and run.jsonl.

    Dtypes: the state, the forward and the Jacobian run in the compute
    dtype (:func:`retrieval_problem`), the LM algebra in float64 on the
    host.  On a mesh every rank runs the LM loop on the same numbers (the
    sharded normal equations, ``parallel.oe``) and rank 0 writes."""
    with open_mesh(cfg, device) as mesh:
        return _retrieve(cfg, device, mesh)


class _ReadOnlyCheckpointer:
    """A rank other than 0 resumes from rank 0's checkpoints and writes
    none.  It reads them at the start of the LM loop, before the loop's
    first collective call, and rank 0 writes its first checkpoint only
    after that call, so every rank resumes from the same one."""

    def __init__(self, ck):
        self.dir, self.latest = ck.dir, ck.latest

    def save(self, *args, **kw) -> None:
        return None


def _retrieve(cfg, device: torch.device, mesh) -> dict:
    from spectrobot_tpu_torch.retrieval.obs import Observation
    from spectrobot_tpu_torch.utils.checkpoint import Checkpointer
    from spectrobot_tpu_torch.utils.runlog import RunLogger
    from spectrobot_tpu_torch.retrieval.oe import OEConfig, retrieve

    engine = select_engine(cfg, device)
    scene = build_scene(cfg, device)
    dtype = scene.nu.dtype
    if _is_rank0(mesh):
        print(f"engine: {_engine_used(scene, engine, device)}",
              file=sys.stderr)
    atm, nb, init, x0, fwd_flat = retrieval_problem(cfg, scene, engine)
    retrieve_vmr = list(cfg.retrieval.retrieve_vmr)
    ret_T = cfg.retrieval.retrieve_temperature
    if nb is not None:
        print(f"retrieving on {nb.n_nodes} altitude nodes "
              f"({nb.z_nodes[0] / 1e3:.1f}-{nb.z_nodes[-1] / 1e3:.1f} km) "
              f"mapped to {atm.n_lev} levels", file=sys.stderr)
    n_fine = int(scene.nu.shape[0])
    oe = None
    if mesh is None:
        # One retrieval: its few Jacobians would not repay a graph's capture.
        jac = make_jacobian(cfg, fwd_flat, int(x0.shape[0]), n_fine, device,
                            graph=False)
    else:
        oe = sharded_problem(cfg, scene, mesh, atm, init(atm), engine,
                             None if nb is None else nb.expand)
        fwd_flat, jac = oe.forward_flat, oe.jacobian

    # Prior blocks in the flat order: "T", then the VMR profiles by sorted
    # species name, each one profile of the parameter basis.
    n_lev = atm.n_lev
    n_par = nb.n_nodes if nb is not None else n_lev
    blocks = ([np.full(n_par, cfg.retrieval.sigma_T ** 2)] if ret_T else [])
    blocks += [np.full(n_par, cfg.retrieval.sigma_lnvmr ** 2)
               for _ in sorted(retrieve_vmr)]
    S_a = np.diag(np.concatenate(blocks))

    n_chan = scene.W.shape[0] if scene.W is not None else n_fine
    chans = scene.chans
    if cfg.retrieval.obs_path:
        obs = Observation.load(cfg.retrieval.obs_path)
        _check_obs_consistency(cfg, obs, chans, n_chan)
    else:
        # Self-test: observations from a truth that perturbs every
        # retrieved quantity.
        atm_true = atm
        if ret_T:
            atm_true = atm_true.with_temperature(atm.T + torch.as_tensor(
                5.0 * np.sin(np.linspace(0, 3, n_lev)), dtype=dtype,
                device=device))
        for s in retrieve_vmr:
            atm_true = atm_true.with_vmr(s, atm.vmr[s] * torch.as_tensor(
                np.exp(0.3 * np.sin(np.linspace(0.5, 2.5, n_lev))),
                dtype=dtype, device=device))
        x_true, _ = flatten_state(init(atm_true))
        y_clean = fwd_flat(x_true).cpu().numpy()
        noise = cfg.instrument.noise or 0.005 * float(y_clean.max())
        obs = Observation.synthesize(y_clean.reshape(n_rays(cfg), n_chan),
                                     chans, noise, seed=0)
    if cfg.retrieval.windows:
        obs = obs.with_windows(cfg.retrieval.windows)
    y_obs, noise_flat = obs.flattened()
    if oe is not None:
        oe.bind_observation(y_obs, noise_flat)

    rank0 = _is_rank0(mesh)
    os.makedirs(cfg.run.output_dir, exist_ok=True)
    log_path = cfg.run.log_file or os.path.join(cfg.run.output_dir,
                                                "run.jsonl")
    ck_dir = cfg.run.checkpoint_dir or os.path.join(cfg.run.output_dir, "ck")
    checkpointer = Checkpointer(ck_dir)
    state_check = None
    if ret_T:
        from spectrobot_tpu_torch.data import tips

        def state_check(x, _lo=float(tips.T_GRID[0]),
                        _hi=float(tips.T_GRID[-1])):
            # The T block leads the flat state; a node basis expands
            # convexly, so node bounds bound the level profile too.
            T = np.asarray(x[:n_par])
            if T.min() < _lo or T.max() > _hi:
                return (f"retrieved temperature "
                        f"[{T.min():.0f}, {T.max():.0f}] K left the "
                        f"partition-sum table range [{_lo:.0f}, {_hi:.0f}] K"
                        f": Q(T) is clamped there; tighten the prior "
                        f"(retrieval.sigma_T) or check the observations")
            return None

    res = retrieve(
        fwd_flat, jac, y_obs, x0, x0, S_a, noise_flat,
        OEConfig(max_iter=cfg.retrieval.max_iter,
                 lm_lambda0=cfg.retrieval.lm_lambda0,
                 chi2_rel_tol=cfg.retrieval.chi2_rel_tol),
        logger=RunLogger(log_path, echo=True) if rank0 else None,
        checkpointer=(checkpointer if rank0
                      else _ReadOnlyCheckpointer(checkpointer)),
        normal_eqs=None if oe is None else oe.normal_eqs,
        state_check=state_check)

    # The fitted spectrum at the solution (one more forward).
    y_fit = fwd_flat(torch.as_tensor(res.x, dtype=dtype, device=device))
    y_fit = y_fit.cpu().numpy().reshape(-1, n_chan)
    out_path = os.path.join(cfg.run.output_dir, "retrieval.npz")
    result = {"converged": bool(res.converged),
              "stop_reason": res.stop_reason, "n_iter": res.n_iter,
              "chi2": float(res.chi2), "output": out_path}
    if not rank0:
        return result
    radiance_spectrum(np.asarray(chans, np.float64), y_fit).save_npz(
        out_path, x=res.x, S_hat=res.S_hat, A_kernel=res.A_kernel,
        chi2=res.chi2, n_iter=res.n_iter, converged=res.converged,
        stop_reason=np.asarray(res.stop_reason),
        y_fit=y_fit,                               # compat alias of values
        y_obs=np.asarray(y_obs).reshape(-1, n_chan),
        noise=np.asarray(noise_flat).reshape(-1, n_chan),
        channels_cm1=np.asarray(chans))            # compat alias of nu
    try:
        from spectrobot_tpu_torch.utils.plots import (
            plot_averaging_kernels, plot_fit, plot_retrieval)
        plot_fit(os.path.join(cfg.run.output_dir, "fit.png"),
                 np.asarray(chans), np.asarray(y_obs).reshape(-1, n_chan),
                 y_fit, np.asarray(noise_flat).reshape(-1, n_chan))
        z_m = atm.z.cpu().numpy() if nb is None else nb.z_nodes
        if ret_T:
            sig = np.sqrt(np.maximum(np.diag(res.S_hat)[:n_par], 0.0))
            plot_retrieval(
                os.path.join(cfg.run.output_dir, "retrieval_T.png"),
                z_m, res.x[:n_par], x0.cpu().numpy()[:n_par], T_sigma=sig)
        plot_averaging_kernels(
            os.path.join(cfg.run.output_dir, "averaging_kernels.png"),
            z_m, res.A_kernel, min(n_par, res.A_kernel.shape[0]))
    except Exception as e:  # plotting must never fail a retrieval
        print(f"plotting skipped: {e}", file=sys.stderr)
    if res.converged:
        status = f"converged ({res.stop_reason})"
    elif res.stop_reason == "max_iter":
        improving = bool(res.history and res.history[-1].get("accepted"))
        status = ("hit retrieval.max_iter with chi2 still improving — raise "
                  "max_iter to converge" if improving
                  else "hit retrieval.max_iter")
    else:
        status = ("LM stalled (lambda exceeded lambda_max — no damping "
                  "produced an acceptable step)")
    print(f"retrieve: {status}; n_iter={res.n_iter} "
          f"chi2={res.chi2:.4g} -> {out_path}", file=sys.stderr)
    return {**result, "status": status}


def cmd_info() -> dict:
    cuda = torch.cuda.is_available()
    devices = ([torch.cuda.get_device_name(i)
                for i in range(torch.cuda.device_count())] if cuda else [])
    engine = (select_engine(Config(), torch.device("cuda")).name
              if cuda else PLAIN.name)

    def computes_in(e: Engine) -> str:
        if e.compute_dtype is None:
            return "the caller's dtype"
        return (f"{str(e.compute_dtype).removeprefix('torch.')} on "
                f"{', '.join(e.compute_devices)} tensors (another dtype "
                f"cast there and back), the caller's dtype elsewhere")

    from spectrobot_tpu_torch.data import hitran_native
    from spectrobot_tpu_torch.data.molparams import MOLECULES
    return {"version": __import__("spectrobot_tpu_torch").__version__,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "devices": devices, "default_engine": engine,
            "engines": {e.name: computes_in(e)
                        for e in (KERNELS, PLAIN, WEIDEMAN)},
            "native_parser_built": hitran_native.available(),
            "molecules_registered": len(MOLECULES),
            "isotopologues_registered": sum(len(m.isotopologues)
                                            for m in MOLECULES.values())}


def main(argv=None) -> int:
    # Full float32 matrix products (the reference pins HIGHEST precision).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    p = argparse.ArgumentParser(prog="spectrobot_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("forward", "retrieve"):
        sp = sub.add_parser(name)
        sp.add_argument("config", nargs="?", default=None)
        sp.add_argument("-o", "--override", action="append", default=[],
                        metavar="SECTION.KEY=VALUE")
        sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sub.add_parser("info")
    args = p.parse_args(argv)

    if args.cmd == "info":
        print(json.dumps(cmd_info(), indent=2))
        return 0
    overrides = dict(ov.partition("=")[::2] for ov in args.override)
    cfg = load_config(args.config, overrides)
    cmd = cmd_forward if args.cmd == "forward" else cmd_retrieve
    result = cmd(cfg, resolve_device(args.device))
    if int(os.environ.get("RANK", 0)) == 0:
        print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
