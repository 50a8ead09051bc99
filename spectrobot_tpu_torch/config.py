"""Typed configuration (C18, SURVEY.md section 6 "config/flag system").

The reference (fedef17/SpectRobot ``spect_robot.py`` [SURVEY.md 1.2]) parses
a bespoke key-value input file.  TPU-native design: one frozen dataclass tree
loaded from TOML with dotted-path CLI overrides; every field is hashable so
the config can be a jit static argument, and ONE object flows down the whole
stack.
"""

from __future__ import annotations

import dataclasses
import tomllib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GridConfig:
    nu_min: float = 630.0
    nu_max: float = 700.0
    n_points: int = 4096


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    planet: str = "mars"
    # "mars_standard" | "titan_standard" | "mars_zonal" (2-D climatology) |
    # path to a 1-D or 2-D (lat x alt, "lat_deg" key) Atmosphere .npz.
    atmosphere: str = "mars_standard"
    latitude_deg: float = 0.0           # observation latitude (2-D sources)
    n_levels: int = 33
    z_top_m: float = 80e3
    species: Tuple[str, ...] = ("CO2",)


@dataclasses.dataclass(frozen=True)
class LinesConfig:
    # "synthetic:<name>[,<name>...]" with names from data.synth, or a path to
    # a HITRAN .par file, or a cached .npz from LineList.save_npz.
    source: str = "synthetic:co2_15um"
    min_sw: Optional[float] = None
    wing_cm1: float = 25.0
    # Sub-Lorentzian wing correction (ops/chi.py): "" = off (bit-identical),
    # or a profile name from ops.chi.CHI_PROFILES (e.g. "co2_mars" — the
    # Perrin & Hartmann 1989 CO2-CO2 first segment).  Applies to the
    # profile's species only; requires compute.cutoff_cm1 <= 30.
    chi: str = ""


@dataclasses.dataclass(frozen=True)
class NLTEConfig:
    """Non-LTE vibrational populations (reference call stack 4.4).

    ``t_vib`` selects the source of vibrational-temperature profiles:
    "" (all matched levels at the kinetic temperature — LTE populations,
    useful to exercise the non-LTE code path), "demo:co2_pump" (built-in
    daytime nu3 pumping ramp, data/nlte.py), or a path to a .npz written by
    ``data.nlte.save_t_vib_npz`` (z, "mol:iso:quanta" keys, t_vib rows).
    """

    enabled: bool = False
    t_vib: str = ""


@dataclasses.dataclass(frozen=True)
class CIAConfig:
    """Collision-induced / continuum absorption (ops/cia.py).

    ``tables`` entries are either "demo:co2" (the built-in synthetic
    CO2-CO2 demo) or "A-B:<path>.cia" — a HITRAN-format CIA file for the
    species pair A, B (both must be in scene.species to take effect).
    """

    enabled: bool = False
    tables: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class GeometryConfig:
    mode: str = "limb"                  # "limb" | "nadir"
    tangent_heights_km: Tuple[float, ...] = (10.0, 20.0, 30.0, 40.0)
    sec_theta: Tuple[float, ...] = (1.0,)
    t_surface: float = 260.0
    emissivity: float = 1.0             # grey surface; <1 adds reflected
                                        # downwelling (nadir only)
    n_sub: int = 4


@dataclasses.dataclass(frozen=True)
class InstrumentConfig:
    enabled: bool = False
    fwhm_cm1: float = 0.5
    shape: str = "gaussian"
    chan_min: float = 0.0               # 0 => grid bounds
    chan_max: float = 0.0
    n_channels: int = 128
    noise: float = 0.0                  # radiance noise sigma
    # Field-of-view smearing over tangent height (C14's FOV half, limb
    # only): fov_fwhm_km > 0 computes radiances on a FINE ladder of
    # fov_n_fine rays spanning the requested tangent heights +- 2 FWHM and
    # smears them into the observed FOVs with ops.ils.fov_matrix.
    fov_fwhm_km: float = 0.0            # 0 => no FOV smearing
    fov_shape: str = "gaussian"
    fov_n_fine: int = 32


@dataclasses.dataclass(frozen=True)
class ComputeConfig:
    dtype: str = "float32"
    variant: str = "humlicek4"          # | "weideman"
    cutoff_cm1: float = 25.0
    chunk: int = 256
    use_pallas: bool = True             # Pallas kernel on TPU, jnp elsewhere
    use_lut: bool = False               # (P,T) LUT runtime (LTE forward only)
    lut_n_T: int = 21
    lut_n_p: int = 25
    lut_path: str = ""                  # persist/reuse the LUT ("" = rebuild)
    lut_build_mesh: bool = False        # shard the lattice build over devices
    mesh_ray: int = 1
    mesh_line: int = 1
    mesh_nu: int = 0                    # 0 => all remaining devices
    # nu-halo line distribution (parallel/sharded.py): lines live on the nu
    # shard owning their center and wings reach neighbours via ring
    # ppermute of line PARAMETERS — neighbour-only ICI traffic instead of
    # the line-axis psum of partial spectra.  Requires
    # cutoff_cm1 <= grid-span / mesh_nu (asserted loudly).
    mesh_halo: bool = False


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    retrieve_temperature: bool = True
    retrieve_vmr: Tuple[str, ...] = ()
    max_iter: int = 15
    lm_lambda0: float = 1e-2
    chi2_rel_tol: float = 1e-3
    sigma_T: float = 10.0               # prior std [K]
    sigma_lnvmr: float = 1.0            # prior std [ln]
    obs_path: str = ""                  # Observation .npz/.csv ("" = self-test)
    windows: Tuple = ()                 # ((lo, hi), ...) spectral windows
    # Coarse retrieval parameter basis (reference bayes-set node grids):
    # 0 = retrieve at every model level (default); N >= 2 = retrieve T and
    # ln-VMR on N equally spaced altitude nodes linearly mapped to levels.
    # node_alt_km overrides with explicit node altitudes (strictly
    # increasing, in km).
    n_nodes: int = 0
    node_alt_km: Tuple = ()
    # Jacobian tangent-batch bound: 0 = auto (plain jacfwd while the tangent
    # batch n_x * n_y fits comfortably, chunked above — the README-measured
    # OOM guard), N > 0 = always chunk to N columns.
    jac_chunk: int = 0


@dataclasses.dataclass(frozen=True)
class RunConfig:
    output_dir: str = "out"
    checkpoint_dir: str = ""            # "" => <output_dir>/ck
    log_file: str = ""                  # "" => <output_dir>/run.jsonl
    # Also write optics.npz from the forward: per-ray LOS optical depth
    # + transmittance Spectra on the fine grid (single-device line-by-line
    # path; reuses the forward's own depths, no extra line sum).
    save_optics: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    grid: GridConfig = GridConfig()
    scene: SceneConfig = SceneConfig()
    lines: LinesConfig = LinesConfig()
    nlte: NLTEConfig = NLTEConfig()
    cia: CIAConfig = CIAConfig()
    geometry: GeometryConfig = GeometryConfig()
    instrument: InstrumentConfig = InstrumentConfig()
    compute: ComputeConfig = ComputeConfig()
    retrieval: RetrievalConfig = RetrievalConfig()
    run: RunConfig = RunConfig()


_SECTIONS = {f.name: f.type for f in dataclasses.fields(Config)}


def _coerce(dc_cls, data: dict):
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(dc_cls)}
    def deep_tuple(v):
        return tuple(deep_tuple(x) if isinstance(x, list) else x for x in v)

    for k, v in data.items():
        if k not in fields:
            raise KeyError(f"unknown config key {dc_cls.__name__}.{k}")
        if isinstance(v, list):
            v = deep_tuple(v)
        kwargs[k] = v
    return dc_cls(**kwargs)


def load_config(path: Optional[str] = None,
                overrides: Optional[dict] = None) -> Config:
    """Load TOML + apply dotted-path overrides ({'grid.n_points': 8192})."""
    data: dict = {}
    if path is not None:
        with open(path, "rb") as f:
            data = tomllib.load(f)
    sections = {}
    for name, cls in _SECTIONS.items():
        if isinstance(cls, str):  # from __future__ annotations
            cls = globals()[cls]
        sections[name] = _coerce(cls, data.get(name, {}))
    cfg = Config(**sections)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


def apply_overrides(cfg: Config, overrides: dict) -> Config:
    for dotted, value in overrides.items():
        sec, _, key = dotted.partition(".")
        if not key:
            raise KeyError(f"override must be section.key, got {dotted!r}")
        section = getattr(cfg, sec)
        old = getattr(section, key)      # raises on unknown key
        if isinstance(old, bool) and isinstance(value, str):
            low = value.strip().lower()
            if low in ("true", "1", "yes", "on"):
                value = True
            elif low in ("false", "0", "no", "off"):
                value = False
            else:
                raise ValueError(f"{dotted}: not a boolean: {value!r}")
        elif old is not None and not isinstance(old, (tuple, type(None))):
            value = type(old)(value)
        elif old is None and isinstance(value, str):
            # Optional fields default to None; they are numeric by contract.
            for cast in (int, float):
                try:
                    value = cast(value)
                    break
                except ValueError:
                    pass
            else:
                raise ValueError(f"{dotted}: not a number: {value!r}")
        elif isinstance(old, tuple) and isinstance(value, str):
            value = tuple(type(old[0])(x) if old else x
                          for x in value.split(","))
        section = dataclasses.replace(section, **{key: value})
        cfg = dataclasses.replace(cfg, **{sec: section})
    return cfg
