"""The plain reference of a non-LTE limb scene under a field of view: the
same physics as the port's line-by-line limb forward with prescribed
vibrational populations (``[nlte]``) and a fine ladder of rays smeared
into the observed fields of view (``instrument.fov_fwhm_km``), written
again in plain PyTorch, with no kernel, no window table and no cache.

It imports nothing of the port.  Where the physics is the LTE scene's it
takes ``physics.py``'s parts (the Mars standard atmosphere, the CO2
partition sum, the Curtis-Godson paths, the line strengths, widths and
shifts, Humlicek's w4 and the line sum, the Gaussian instrument function,
the TF32 rounding of the control), and it adds frozen copies of:

- the rovib band recipe (``data/synth.py``: ``rovib_band``,
  ``co2_43um_band``, ``co2_43um_hot_band``), each number rounded as the
  HITRAN record the recipe writes holds it, with the global quanta;
- the level registry and its matching (``data/nlte.py``:
  ``registry_from_linelist``, ``match_lines_to_levels``): a level's energy
  the least lower-state energy of the lines it is the lower level of, else
  the least E'' + nu0 of those it is the upper level of;
- the daytime pump (``data/nlte.py`` ``demo_pump_t_vib``): levels whose
  last global quantum is above 0 ramp from T_kin at 50 km to 1.35 T_kin at
  90 km, prescribed once from the configured atmosphere on the layer
  midpoints (``cli._build_nlte``), the other levels at T_kin there;
- the population weights (``data/nlte.py`` ``_line_weights``): r = exp(-c2
  E_level (1/T_vib - 1/T_kin)) of each line's upper and lower level at each
  (ray, layer) state's air temperature T_kin, E = exp(-c2 nu0 / T_kin),
  w_abs = (r_l - r_u E) / (1 - E), w_em = r_u;
- the source B(T_air) k_em / k_abs with the port's guard against a
  vanishing k_abs (``forward/limb.py`` ``optics_from_tau``);
- the fine ladder (``cli._build_fov``: ``fov_n_fine`` rays over the
  observed tangent heights +- 2 FWHM, clipped at the surface, the rays
  above the model top crossing nothing) and its smear V @ I before the
  instrument function (``ops/ils.py`` ``fov_matrix``, ``apply_fov``).

Departures from the port's formulas: the absorption and emission depths are
two line sums of the same Voigt values, where K1 sums both amplitude rows
of a state in one pass; a weight multiplies the line's whole amplitude u S
sqrt(ln2 / pi) / alpha_D where the port weights the column u first (the
same product, rounded in another order).  Precision as ``physics.py``
states it; under "tf32" the smear's product is rounded too, as the
instrument function's is.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import forward_ad as fwAD

from spectrobench.reference import physics
from spectrobench.reference.physics import C1B, C2, T_REF

# The catalog's bands (data/synth.py co2_43um_band, co2_43um_hot_band):
# centre [cm-1], band strength [cm-1/(molec cm-2)], rotational constant
# [cm-1], global quanta (upper, lower), and the vibrational energy added to
# every lower-state energy (the hot band's lower level, 667.38 cm-1).
BANDS = ((2349.14, 9.5e-17, 0.3871, "0001", "0000", 0.0),
         (2336.63, 8.0e-18, 0.3871, "0111", "0110", 667.38))
# Both bands' widths, temperature exponent and shift.
GAMMA_AIR, GAMMA_SELF, N_AIR, DELTA_AIR = 0.07, 0.095, 0.7, -0.002
# The width of a quanta field of the HITRAN record.
QUANTA_WIDTH = 15
# The daytime pump: the boost at the top of the ramp, where it starts and
# over what height it rises [m].
PUMP_BOOST, PUMP_ONSET_M, PUMP_SCALE_M = 0.35, 50e3, 40e3


def _held(values, fmt: str) -> np.ndarray:
    """``values`` as the record's fixed field of format ``fmt`` holds
    them."""
    return np.array([float(format(v, fmt)) for v in values])


def rovib_band(nu_band: float, s_band: float, b_rot: float, quanta_u: str,
               quanta_l: str, e_vib_lower: float, j_max: int) -> dict:
    """One rigid-rotor band's line columns: P branch nu_band - 2B J (J = 1
    to ``j_max``), R branch nu_band + 2B (J + 1) (J = 0 to ``j_max``),
    E'' = B J (J + 1) + ``e_vib_lower``, strengths J e^(-c2 E''/296) (P)
    and (J + 1) e^(-c2 E''/296) (R) summing to ``s_band``."""
    J_p = np.arange(1, j_max + 1)
    J_r = np.arange(0, j_max + 1)
    e_p = b_rot * J_p * (J_p + 1.0)
    e_r = b_rot * J_r * (J_r + 1.0)
    w_p = J_p * np.exp(-C2 * e_p / T_REF)
    w_r = (J_r + 1.0) * np.exp(-C2 * e_r / T_REF)
    norm = s_band / (w_p.sum() + w_r.sum())
    j = np.concatenate([J_p, J_r])
    n = j.shape[0]
    quanta = lambda q: np.full(n, q.rjust(QUANTA_WIDTH),
                               dtype=f"U{QUANTA_WIDTH}")
    return {
        "nu0": _held(np.concatenate([nu_band - 2.0 * b_rot * J_p,
                                     nu_band + 2.0 * b_rot * (J_r + 1)]),
                     ".6f"),
        "sw": _held(norm * np.concatenate([w_p, w_r]), ".3E"),
        "a_einstein": np.ones(n),
        "gamma_air": np.full(n, GAMMA_AIR),
        "gamma_self": np.full(n, GAMMA_SELF),
        "elower": _held(np.concatenate([e_p, e_r]), ".4f") + e_vib_lower,
        "n_air": np.full(n, N_AIR),
        "delta_air": np.full(n, DELTA_AIR),
        "gp": 2.0 * j + 1.0,
        "gpp": 2.0 * j + 1.0,
        "mass_amu": np.full(n, physics.CO2_MASS_AMU),
        "mol_id": np.full(n, 2, dtype=np.int32),
        "iso_id": np.full(n, 1, dtype=np.int32),
        "quanta_global_u": quanta(quanta_u),
        "quanta_global_l": quanta(quanta_l),
    }


def co2_43um_bands(j_max) -> dict:
    """The nu3 fundamental and its first hot band, to ``j_max`` = (J of the
    fundamental, J of the hot band), their columns joined."""
    parts = [rovib_band(*band, j_max=int(j)) for band, j in zip(BANDS, j_max)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


class Scene(NamedTuple):
    """A non-LTE limb scene as the reference takes it: ``physics.Scene``'s
    fields (``h_t`` the rays the forward runs: the fine ladder under a field
    of view) and the populations and the smear, all host arrays."""
    nu: np.ndarray            # [P] the grid [cm-1]
    nu_ref: float             # the lines' wavenumber origin [cm-1]
    lines: dict               # [L] columns, sorted by nu0
    atm: dict                 # the prior atmosphere (mars_standard's keys)
    h_t: np.ndarray           # [R] tangent heights of the rays run [m]
    n_sub: int
    cutoff: float             # [cm-1]
    W: np.ndarray             # [n_chan, P] instrument function
    q: np.ndarray             # [n_T] Q(T) on physics.T_GRID
    V: Optional[np.ndarray]   # [n_obs, R] field of view, or None
    lev_u: np.ndarray         # [L] each line's upper level (-1: none)
    lev_l: np.ndarray         # [L] each line's lower level (-1: none)
    e_level: np.ndarray       # [n_levels] level energies [cm-1]
    t_vib: Optional[np.ndarray]  # [n_levels, NL] [K], or None: LTE
    parts: str                # physics.py's digest: the cached truths'
                              # key digests the scene, so it follows
                              # physics.py too


def levels(mol, iso, quanta_u, quanta_l, elower, nu0) -> tuple:
    """(lev_u, lev_l [L] int, energies [n_levels], quanta [n_levels]) of
    the line columns: the lower levels by energy, then the upper levels
    that are no line's lower level, by energy."""
    lower, upper = {}, {}
    for k in range(len(nu0)):
        lo = (int(mol[k]), int(iso[k]), str(quanta_l[k]).strip())
        up = (int(mol[k]), int(iso[k]), str(quanta_u[k]).strip())
        lower[lo] = min(lower.get(lo, np.inf), float(elower[k]))
        upper[up] = min(upper.get(up, np.inf),
                        float(elower[k] + nu0[k]))
    keys = sorted(lower, key=lower.get)
    keys += [k for k in sorted(upper, key=upper.get) if k not in lower]
    index = {k: i for i, k in enumerate(keys)}
    energy = {**upper, **lower}

    def of(quanta):
        return np.array([index.get((int(m), int(i), str(q).strip()), -1)
                         for m, i, q in zip(mol, iso, quanta)], np.int64)

    return (of(quanta_u), of(quanta_l),
            np.array([energy[k] for k in keys]), [k[2] for k in keys])


def pumped_t_vib(atm: dict, quanta) -> np.ndarray:
    """The daytime pump's vibrational temperatures [n_levels, NL] on the
    layer midpoints of the atmosphere ``atm``: T_kin there (linear in
    altitude between the levels), ramped for the levels whose last global
    quantum is above 0."""
    z = atm["z"]
    z_mid = 0.5 * (z[1:] + z[:-1])
    T_lay = np.interp(z_mid, z, atm["T"])
    ramp = 1.0 + PUMP_BOOST * np.clip((z_mid - PUMP_ONSET_M) / PUMP_SCALE_M,
                                      0.0, 1.0)
    pumped = [q and q[-1].isdigit() and q[-1] != "0" for q in quanta]
    return np.stack([T_lay * ramp if p else T_lay for p in pumped])


def fov_ladder(h_obs_km, fwhm_km: float, n_fine: int) -> tuple:
    """(tangent heights of the fine ladder [km], V [n_obs, n_fine]): the
    observed heights +- 2 FWHM, clipped at 0 km, and the Gaussian field of
    view of each observed ray on it (area-normalised, truncated at 6
    FWHM)."""
    h_obs = np.asarray(h_obs_km, np.float64)
    lo = max(float(h_obs.min()) - 2.0 * fwhm_km, 0.0)
    h_km = np.linspace(lo, float(h_obs.max()) + 2.0 * fwhm_km, n_fine)
    return h_km, physics.ils_matrix(h_km * 1e3, h_obs * 1e3, fwhm_km * 1e3)


def make_scene(grid: dict, lines: dict, atm: dict, geometry: dict,
               instrument: dict, cutoff: float, wing: float,
               grid_dtype=np.float32, pump: bool = True) -> Scene:
    """The reference scene of a configuration's sections (as
    ``physics.make_scene`` takes them; ``instrument`` also has fov_fwhm_km,
    0 for none, and fov_n_fine), the line columns ``lines`` with their
    quanta and the atmosphere ``atm``; ``pump`` false: LTE populations."""
    h_km = np.asarray(geometry["tangent_heights_km"], np.float64)
    V = None
    if instrument["fov_fwhm_km"] > 0:
        h_km, V = fov_ladder(h_km, instrument["fov_fwhm_km"],
                             int(instrument["fov_n_fine"]))
    base = physics.make_scene(grid, lines, atm,
                              {**geometry, "tangent_heights_km": h_km},
                              instrument, cutoff, wing, grid_dtype)
    # The lines physics.make_scene keeps, in its order.
    keep = ((lines["nu0"] >= grid["nu_min"] - wing)
            & (lines["nu0"] <= grid["nu_max"] + wing))
    order = np.argsort(lines["nu0"][keep], kind="stable")
    col = lambda k: np.asarray(lines[k])[keep][order]
    lev_u, lev_l, e_level, quanta = levels(
        col("mol_id"), col("iso_id"), col("quanta_global_u"),
        col("quanta_global_l"), col("elower"), col("nu0"))
    t_vib = pumped_t_vib(base.atm, quanta) if pump else None
    parts = hashlib.sha256(Path(physics.__file__).read_bytes()).hexdigest()
    return Scene(*base, V, lev_u, lev_l, e_level, t_vib, parts)


# ---------------------------------------------------------------------------
# The forward.
# ---------------------------------------------------------------------------


def layer_weights(scene: Scene, T_air: torch.Tensor):
    """(w_abs, w_em) [R, NL, L] at each state's air temperature ``T_air``
    [R, NL], or None in LTE.  The level energies and vibrational
    temperatures are held in float32 (the compute dtype the program stages
    them in), the line centres as the line states hold them."""
    if scene.t_vib is None:
        return None
    dev = T_air.device
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    T = T_air[..., None]
    r_lvl = torch.exp(-C2 * f32(scene.e_level)
                      * (1.0 / f32(scene.t_vib).T[None] - 1.0 / T))

    def ratio(idx):
        i = torch.as_tensor(idx, device=dev)
        return torch.where(i >= 0, r_lvl[..., i.clamp(min=0)], 1.0)

    r_u, r_l = ratio(scene.lev_u), ratio(scene.lev_l)
    nu0_abs = (f32(scene.lines["nu0"] - scene.nu_ref) + f32(scene.nu_ref))
    E = torch.exp(-C2 * nu0_abs / T)
    return (r_l - r_u * E) / (1.0 - E), r_u


def radiance(scene: Scene, path: physics.Path, dtau: torch.Tensor,
             dtau_em: torch.Tensor, precision: str) -> torch.Tensor:
    """The observed spectra y [n_obs x n_chan] of the absorption and
    emission depths [R, NL, P]: sources B(T_air) k_em / k_abs (B on the grid
    in the line sum's dtype; where k_abs is below the port's guard, B),
    segment sums in observer-first order (deep space behind), the field of
    view V @ I over the rays, then the instrument function, each product in
    the promoted dtype of its factors (physics.radiance with the source
    ratio and the smear)."""
    dt, dev = dtau.dtype, dtau.device
    nu = torch.as_tensor(scene.nu, dtype=dt, device=dev)
    B = C1B * nu ** 3 / torch.expm1(C2 * nu / path.T_air[:, :, None])
    tiny = 1e-150 if dt == torch.float64 else 1e-16
    ratio = dtau_em / torch.clamp(dtau, min=tiny)
    source = B * torch.where(dtau > tiny, ratio, 1.0)
    c = torch.cumsum(dtau.index_select(-2, path.seg_layer), dim=-2)
    t_after = torch.exp(-c)
    t_before = torch.cat([torch.ones_like(t_after[..., :1, :]),
                          t_after[..., :-1, :]], dim=-2)
    w_layer = torch.zeros_like(dtau).index_add(
        1, path.seg_layer, t_before - t_after)
    I = torch.sum(source * w_layer, dim=-2)
    if scene.V is not None:
        V = torch.as_tensor(scene.V, dtype=dt, device=dev).to(I.dtype)
        I = physics.matmul(V, I, precision)
    W = torch.as_tensor(scene.W, dtype=dt, device=dev).to(I.dtype)
    return physics.matmul(I, W.T, precision).reshape(-1)


def forward(scene: Scene, T_lev, vmr_lev, precision: str = "float32",
            device="cpu", state_dtype=torch.float32) -> torch.Tensor:
    """y [n_obs x n_chan] at temperature ``T_lev`` and CO2 VMR ``vmr_lev``
    [n_lev] (tensors or arrays, held in ``state_dtype``; forward-mode duals
    pass through)."""
    dt = state_dtype
    t = lambda a: (a.to(dt) if isinstance(a, torch.Tensor) else
                   torch.as_tensor(np.asarray(a), dtype=dt, device=device))
    path = physics.limb_path(scene, t(T_lev), t(vmr_lev))
    ls = physics.line_states(scene, path)
    R, NL = path.u.shape
    depth = lambda amp: physics.line_sum(scene, ls._replace(amp=amp),
                                         precision).reshape(R, NL, -1)
    w = layer_weights(scene, path.T_air)
    if w is None:
        dtau = dtau_em = depth(ls.amp)
    else:
        dtau, dtau_em = (depth(ls.amp * wk.reshape(R * NL, -1)) for wk in w)
    return radiance(scene, path, dtau, dtau_em, precision)


def jvp(scene: Scene, T_lev, vmr_lev, dT, dvmr, precision: str = "float32",
        device="cpu", state_dtype=torch.float32) -> tuple:
    """(y, dy): the spectra and their derivative along (dT, dvmr) by
    forward-mode AD through the same computation."""
    dt = state_dtype
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    with fwAD.dual_level():
        T = fwAD.make_dual(t(T_lev), t(dT))
        v = fwAD.make_dual(t(vmr_lev), t(dvmr))
        out = fwAD.unpack_dual(forward(scene, T, v, precision, device,
                                       state_dtype))
        tangent = (out.tangent if out.tangent is not None
                   else torch.zeros_like(out.primal))
        return out.primal.clone(), tangent.clone()


# The line-sum inputs a state requires, as the yardstick counts them: those
# of every (ray, layer) state of the rays the forward runs (the fine ladder
# under a field of view), each of K1's two amplitude rows counted by the
# yardstick (physics.required_work on this scene).
required_work = physics.required_work


# ---------------------------------------------------------------------------
# The scene a configuration describes (the functions the harness takes from
# a reference module: physics.py's list).
# ---------------------------------------------------------------------------

prior = physics.prior


def inputs(cfg, bench: dict) -> tuple:
    """(lines, atm): the configuration's line list, ``[bench.lines]``'s
    recipe (``co2_43um_bands`` at its ``j_max``), and its atmosphere
    (``[bench] atmosphere``), as the program reads them from files."""
    spec = bench["lines"]
    if spec["recipe"] != "co2_43um_bands":
        raise ValueError(f"no line recipe {spec['recipe']!r}")
    if bench["atmosphere"] != "mars_standard":
        raise ValueError(f"no atmosphere {bench['atmosphere']!r}")
    return (co2_43um_bands(spec["j_max"]),
            physics.mars_standard(cfg.scene.n_levels, cfg.scene.z_top_m))


def covers(cfg) -> None:
    """Raise unless this reference covers the configuration: a CO2 limb
    scan with the daytime pump's populations, a Gaussian field of view and
    a Gaussian instrument function, no continuum, no wing correction, no
    table, humlicek4."""
    bad = []
    ins = cfg.instrument
    if cfg.geometry.mode != "limb":
        bad.append("geometry.mode")
    if not cfg.nlte.enabled or cfg.nlte.t_vib != "demo:co2_pump":
        bad.append("nlte")
    if cfg.cia.enabled or cfg.lines.chi:
        bad.append("cia/chi")
    if (not ins.enabled or ins.shape != "gaussian" or ins.fov_fwhm_km <= 0
            or ins.fov_shape != "gaussian"):
        bad.append("instrument")
    if cfg.compute.use_lut or cfg.compute.variant != "humlicek4":
        bad.append("compute")
    if tuple(cfg.scene.species) != ("CO2",):
        bad.append("scene.species")
    if bad:
        raise ValueError(f"the plain reference does not cover {bad}")


def configured_scene(cfg, lines: dict, atm: dict) -> Scene:
    """The reference scene of the program's configuration ``cfg`` on the
    line list and atmosphere :func:`inputs` made (LTE populations where
    ``[nlte]`` is off, no smear where the field of view is 0)."""
    ins = cfg.instrument
    return make_scene(
        {"nu_min": cfg.grid.nu_min, "nu_max": cfg.grid.nu_max,
         "n_points": cfg.grid.n_points},
        lines, atm,
        {"tangent_heights_km": cfg.geometry.tangent_heights_km,
         "n_sub": cfg.geometry.n_sub},
        {"fwhm_cm1": ins.fwhm_cm1, "n_channels": ins.n_channels,
         "chan_min": ins.chan_min, "chan_max": ins.chan_max,
         "fov_fwhm_km": ins.fov_fwhm_km, "fov_n_fine": ins.fov_n_fine},
        cfg.compute.cutoff_cm1, cfg.lines.wing_cm1,
        grid_dtype=np.float64 if cfg.compute.dtype == "float64"
        else np.float32,
        pump=cfg.nlte.enabled)
