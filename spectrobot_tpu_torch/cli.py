"""Command-line entry point of the port:

    python -m spectrobot_tpu_torch forward cfg.toml [-o section.key=value ...]
                                              [--device {cuda,cpu}]
    python -m spectrobot_tpu_torch info

It reads the reference's TOML schema (``spectrobot_tpu.config``) and writes
``run.output_dir/forward.npz`` in the reference's layout.  The forward is the
single-device line-by-line limb/nadir path in local thermodynamic
equilibrium; every configuration feature outside it raises
``NotImplementedError`` naming its key.

Engine rule: on CUDA the opacity line sum runs in the CUDA kernel
(``compute.use_pallas = true`` with ``compute.variant = "humlicek4"`` in
float32); on the CPU its plain PyTorch version runs.  ``--device cuda``
without a GPU raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from spectrobot_tpu.config import Config, load_config
from spectrobot_tpu_torch.data import atmosphere as atm_mod
from spectrobot_tpu_torch.data.lines import configured_lines
from spectrobot_tpu_torch.forward.geometry import limb_path_cg, nadir_path_cg
from spectrobot_tpu_torch.forward.limb import layer_tau_kernel, radiance_from_tau
from spectrobot_tpu_torch.ops.cuda_opacity import (
    accumulate_batch, accumulate_batch_plain)
from spectrobot_tpu_torch.ops.ils import apply_ils, ils_matrix
from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist
from spectrobot_tpu_torch.spectra import radiance as radiance_spectrum

# Where each unported feature will come from (ROADMAP.md, Queue 1).
_LATER_PHYSICS = "ROADMAP Queue 1 item 6 (off-main physics)"
_LATER_MESH = "ROADMAP Queue 1 item 7 (the mesh)"


def _not_ported(key: str, value, roadmap_item: str):
    return NotImplementedError(
        f"{key} = {value!r} is not ported to spectrobot_tpu_torch yet "
        f"({roadmap_item})")


def check_ported(cfg) -> None:
    """Raise NotImplementedError naming the first config key whose feature
    this port does not have yet."""
    c = cfg.compute
    unported = [
        ("nlte.enabled", cfg.nlte.enabled, _LATER_PHYSICS),
        ("cia.enabled", cfg.cia.enabled, _LATER_PHYSICS),
        ("lines.chi", cfg.lines.chi, _LATER_PHYSICS),
        ("instrument.fov_fwhm_km", cfg.instrument.fov_fwhm_km > 0,
         _LATER_PHYSICS),
        ("compute.use_lut", c.use_lut, _LATER_PHYSICS),
        ("compute.variant", c.variant != "humlicek4", _LATER_PHYSICS),
        ("compute.mesh_ray", c.mesh_ray != 1, _LATER_MESH),
        ("compute.mesh_line", c.mesh_line != 1, _LATER_MESH),
        ("compute.mesh_nu", c.mesh_nu != 0, _LATER_MESH),
        ("compute.mesh_halo", c.mesh_halo, _LATER_MESH),
        ("run.save_optics", cfg.run.save_optics, _LATER_PHYSICS),
    ]
    for key, used, item in unported:
        if used:
            section, name = key.split(".")
            raise _not_ported(key, getattr(getattr(cfg, section), name),
                              item)
    src = cfg.scene.atmosphere
    is_2d = src == "mars_zonal"
    if src.endswith(".npz"):
        with np.load(src) as z:
            is_2d = "lat_deg" in z.files
    if is_2d:
        raise _not_ported("scene.atmosphere", src,
                          _LATER_PHYSICS + ", 2-D atmospheres")


def select_accumulate(cfg, device: torch.device):
    """The engine rule: the opacity line sum, checked against the
    configuration on CUDA.  :func:`accumulate_batch` itself sends CPU
    tensors to its plain version, in any dtype."""
    if device.type == "cpu":
        return accumulate_batch
    if not cfg.compute.use_pallas:
        raise NotImplementedError(
            "compute.use_pallas = false on CUDA: the CUDA opacity kernel is "
            "the port's only CUDA engine (set compute.use_pallas = true, or "
            "run the plain version with --device cpu)")
    if cfg.compute.dtype != "float32":
        raise NotImplementedError(
            f"compute.dtype = {cfg.compute.dtype!r} on CUDA: the CUDA "
            f"opacity kernel is float32 (run float64 with --device cpu)")
    return accumulate_batch


def _build_atmosphere(cfg, device):
    planet = atm_mod.PLANETS[cfg.scene.planet.lower()]
    src = cfg.scene.atmosphere
    if src == "mars_standard":
        atm = atm_mod.mars_standard_atmosphere(
            n_lev=cfg.scene.n_levels, z_top=cfg.scene.z_top_m, device=device)
    elif src == "titan_standard":
        atm = atm_mod.titan_standard_atmosphere(
            n_lev=cfg.scene.n_levels, z_top=cfg.scene.z_top_m, device=device)
    else:
        atm = atm_mod.Atmosphere.load_npz(src, device=device)
    return planet, atm


class Scene(NamedTuple):
    planet: atm_mod.Planet
    atm: atm_mod.Atmosphere
    lines: object              # DeviceLines
    species_names: list
    nu: torch.Tensor           # [P] grid, compute dtype
    nu_off: torch.Tensor       # [P] grid - lines.nu_ref, staged from f64
    W: object                  # [n_chan, P] ILS matrix or None
    chans: np.ndarray          # output axis (channels, or the fine grid)


def build_scene(cfg, device: torch.device) -> Scene:
    """Config -> the forward's inputs on ``device``."""
    from spectrobot_tpu.data.molparams import MOLECULES, molecule_by_name

    check_ported(cfg)
    dtype = torch.float64 if cfg.compute.dtype == "float64" else torch.float32
    planet, atm = _build_atmosphere(cfg, device)
    ll = configured_lines(cfg)
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
    return Scene(planet, atm, dl, species_names, nu, nu_off, W, chans)


def path_cg(cfg, scene: Scene):
    """The configured rays' Curtis-Godson states, and the surface
    temperature (None for limb rays)."""
    g = cfg.geometry
    dtype, device = scene.nu.dtype, scene.nu.device
    if g.mode == "limb":
        h_t = torch.as_tensor(np.asarray(g.tangent_heights_km, float) * 1e3,
                              dtype=dtype, device=device)
        return limb_path_cg(scene.atm, scene.species_names, h_t,
                            scene.planet, g.n_sub), None
    sec = torch.as_tensor(g.sec_theta, dtype=dtype, device=device)
    return (nadir_path_cg(scene.atm, scene.species_names, sec, g.n_sub),
            g.t_surface)


def run_forward(cfg, scene: Scene, accumulate) -> torch.Tensor:
    """Radiances of the configured rays ([R, n_chan] with the instrument,
    else [R, P]), with ``accumulate`` as the opacity line sum."""
    cg, t_surf = path_cg(cfg, scene)
    dtau, dtau_em = layer_tau_kernel(scene.nu_off, scene.lines, cg,
                                     cutoff_cm1=cfg.compute.cutoff_cm1,
                                     accumulate=accumulate)
    I = radiance_from_tau(scene.nu.to(dtau.dtype), cg, dtau, dtau_em,
                          T_surface=t_surf,
                          emissivity=cfg.geometry.emissivity)
    if scene.W is not None:
        I = apply_ils(I, scene.W)
    return I


def resolve_device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available "
                           "(use --device cpu for the plain version)")
    return torch.device(name)


def cmd_forward(cfg, device: torch.device) -> dict:
    accumulate = select_accumulate(cfg, device)
    scene = build_scene(cfg, device)
    t0 = time.time()
    I = run_forward(cfg, scene, accumulate)
    I = I.cpu().numpy()                 # waits for the device
    wall = time.time() - t0

    os.makedirs(cfg.run.output_dir, exist_ok=True)
    out_path = os.path.join(cfg.run.output_dir, "forward.npz")
    # After ILS channelisation the spectral axis is the channel centers.
    sp = radiance_spectrum(np.asarray(scene.chans, np.float64), I)
    extra = {"tangent_heights_km": np.asarray(cfg.geometry.tangent_heights_km)}
    if scene.W is not None:
        extra["nu_fine"] = scene.nu.cpu().numpy()
    sp.save_npz(out_path, radiance=I, **extra)   # 'radiance' = compat alias
    print(f"forward: {I.shape} radiances in {wall:.2f}s on {device} -> "
          f"{out_path}", file=sys.stderr)
    return {"radiance_shape": list(I.shape), "wall_s": wall,
            "output": out_path, "n_lines": scene.lines.n_lines,
            "device": str(device)}


def cmd_info() -> dict:
    cuda = torch.cuda.is_available()
    devices = ([torch.cuda.get_device_name(i)
                for i in range(torch.cuda.device_count())] if cuda else [])
    engine = (select_accumulate(Config(), torch.device("cuda")).__name__
              if cuda else accumulate_batch_plain.__name__)
    return {"version": __import__("spectrobot_tpu_torch").__version__,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "devices": devices, "default_engine": engine}


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
    if args.cmd == "retrieve":
        raise NotImplementedError(
            "the retrieve command is not ported to spectrobot_tpu_torch yet "
            "(ROADMAP Queue 1 items 2-3: Jacobian, then the LM retrieval)")

    overrides = dict(ov.partition("=")[::2] for ov in args.override)
    cfg = load_config(args.config, overrides)
    result = cmd_forward(cfg, resolve_device(args.device))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
