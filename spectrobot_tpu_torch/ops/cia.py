"""Collision-induced absorption / continuum opacity (port of
``spectrobot_tpu.ops.cia``).

CIA is a binary-collision phenomenon, so its optical depth along a path
scales with the DENSITY-SQUARED path integral rather than the column:

    dtau_cia(nu) = sum_pairs  k_ab(nu, T) * x_a x_b * int n_air^2 ds

with k_ab the binary absorption coefficient [cm^5 molec^-2] (the HITRAN CIA
convention) and x the (layer-mean) mixing ratios.  ``PathCG.uu_air`` holds
int n_air^2 ds scaled by the exact power of two ``geometry.UU_SCALE``, and
``PathCG.u_air`` the air column for the mixing ratios.

The host parts (:class:`CIATable`, :func:`cia_from_arrays`,
:func:`parse_cia_text`, :func:`demo_co2_cia`) are copies of the
reference's.  :func:`stage_cia` resamples the tables onto the forward grid
on the host in float64, folds the inverse scale and every unit conversion
in, and packs them into one ``[n_pair, nT, P]`` tensor; :func:`cia_dtau`
interpolates it linearly in T_air on the device, differentiable in the
temperature and (through the mixing ratios) in the VMR state.  The same
dtau is added to the absorption and the emission depths: the continuum
thermalises at the kinetic temperature.

:func:`demo_co2_cia` is a SYNTHETIC table with a plausible magnitude and
band shape, for tests and examples; it is not measured data.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from spectrobot_tpu_torch.forward.geometry import UU_SCALE, PathCG


class CIATable(NamedTuple):
    """One pair's host-side table (HITRAN CIA units)."""
    species_a: str
    species_b: str
    nu_grid: np.ndarray     # [Pc] cm-1 (ascending)
    T_grid: np.ndarray      # [nT] K (ascending)
    k: np.ndarray           # [nT, Pc] binary absorption [cm^5 molec^-2]


class DeviceCIA(NamedTuple):
    """Staged CIA set: tables on the forward grid, scale folded in."""
    tables: torch.Tensor     # [n_pair, nT, P] k * 1e-10 / UU_SCALE (f32-safe)
    T_grid: torch.Tensor     # [nT] shared temperature grid
    pair_a: Tuple[int, ...]  # species-axis indices
    pair_b: Tuple[int, ...]

    @property
    def n_pairs(self) -> int:
        return len(self.pair_a)


def cia_from_arrays(species_a: str, species_b: str, nu, T, k) -> CIATable:
    nu = np.asarray(nu, np.float64)
    T = np.asarray(T, np.float64)
    k = np.asarray(k, np.float64)
    assert k.shape == (T.shape[0], nu.shape[0]), (k.shape, T.shape, nu.shape)
    return CIATable(species_a, species_b, nu, T, k)


def parse_cia_text(text: str, species_a: str, species_b: str) -> CIATable:
    """Parse a HITRAN-format ``.cia`` file: repeated blocks of one header
    line (pair label, nu_min, nu_max, n_points, temperature, max_cia, ...)
    followed by n_points ``nu  k`` rows.  Blocks (one per temperature) are
    re-interpolated onto the first block's wavenumber grid."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    i = 0
    temps: List[float] = []
    grids: List[np.ndarray] = []
    ks: List[np.ndarray] = []
    while i < len(lines):
        head = lines[i].split()
        # Header: label nu_min nu_max n_pts T [max_cia [res [comments]]]
        n_pts = int(head[3])
        temps.append(float(head[4]))
        block = np.loadtxt([ln for ln in lines[i + 1:i + 1 + n_pts]])
        grids.append(block[:, 0])
        ks.append(block[:, 1])
        i += 1 + n_pts
    order = np.argsort(temps)
    nu0 = grids[order[0]]
    k = np.stack([
        np.interp(nu0, grids[j], ks[j], left=0.0, right=0.0) for j in order
    ])
    return CIATable(species_a, species_b, nu0,
                    np.asarray(temps, np.float64)[order], k)


def demo_co2_cia(nu_min: float = 0.0, nu_max: float = 3000.0) -> CIATable:
    """SYNTHETIC CO2-CO2 continuum demo table (NOT measured data).

    Shape: a rototranslational induced-dipole hump peaking near 50 cm-1
    plus a weak induced band near the Fermi-dyad region (~1300 cm-1), with
    a ~T^-1.5 temperature dependence and a peak binary coefficient of
    ~1.2e-46 cm^5 molec^-2 at 200 K — the right order of magnitude for
    Mars-relevant CO2 continua.  Use real HITRAN CIA data via
    :func:`parse_cia_text` for science."""
    nu = np.linspace(max(nu_min, 1.0), nu_max, 512)
    T = np.array([100.0, 150.0, 200.0, 250.0, 300.0, 350.0])
    roto = np.exp(-0.5 * ((nu - 50.0) / 60.0) ** 2)
    fermi = 0.08 * np.exp(-0.5 * ((nu - 1300.0) / 80.0) ** 2)
    shape = roto + fermi                                   # [Pc]
    amp = 1.2e-46 * (200.0 / T) ** 1.5                     # [nT]
    return CIATable("CO2", "CO2", nu, T, amp[:, None] * shape[None, :])


def stage_cia(nu_grid, tables: Sequence[CIATable], species: Sequence[str],
              *, device, dtype=torch.float32) -> Optional[DeviceCIA]:
    """Resample host tables onto the forward grid ``nu_grid`` [P] (host
    array or tensor) and fold in units/scale, on ``device``.

    ``species`` is the forward model's ordered species list; tables whose
    pair is not fully present are skipped.  Returns None when nothing
    remains.  All tables are re-interpolated onto a SHARED temperature grid
    (the union range at the finest table's resolution) so the device
    interpolation is one fractional index per layer.
    """
    name_to_idx = {s.upper(): i for i, s in enumerate(species)}
    keep = [t for t in tables
            if t.species_a.upper() in name_to_idx
            and t.species_b.upper() in name_to_idx]
    if not keep:
        return None
    T_lo = min(float(t.T_grid[0]) for t in keep)
    T_hi = max(float(t.T_grid[-1]) for t in keep)
    n_T = max(max(t.T_grid.shape[0] for t in keep), 2)
    T_shared = np.linspace(T_lo, T_hi, n_T)
    if isinstance(nu_grid, torch.Tensor):
        nu_grid = nu_grid.detach().cpu().numpy()
    nu_host = np.asarray(nu_grid, np.float64)

    staged = []
    for t in keep:
        # nu first (shared grid), then T onto the shared grid.
        k_nu = np.stack([
            np.interp(nu_host, t.nu_grid, t.k[j], left=0.0, right=0.0)
            for j in range(t.T_grid.shape[0])
        ])                                                  # [nT_t, P]
        if t.T_grid.shape[0] == 1:
            k_T = np.broadcast_to(k_nu[0], (n_T, nu_host.shape[0])).copy()
        else:
            idx = np.searchsorted(t.T_grid, T_shared).clip(
                1, t.T_grid.shape[0] - 1)
            wT = ((T_shared - t.T_grid[idx - 1])
                  / (t.T_grid[idx] - t.T_grid[idx - 1])).clip(0.0, 1.0)
            k_T = k_nu[idx - 1] * (1.0 - wT[:, None]) + k_nu[idx] * wT[:, None]
        # Units: dtau = k[cm^5 molec^-2] * (uu_SI * 1e-10)[molec^2 cm^-5]
        #             = (k * 1e-10 / UU_SCALE) * uu_scaled
        staged.append(k_T * (1.0e-10 / UU_SCALE))
    return DeviceCIA(
        tables=torch.as_tensor(np.stack(staged), dtype=dtype, device=device),
        T_grid=torch.as_tensor(T_shared, dtype=dtype, device=device),
        pair_a=tuple(name_to_idx[t.species_a.upper()] for t in keep),
        pair_b=tuple(name_to_idx[t.species_b.upper()] for t in keep),
    )


def cia_dtau(cia: DeviceCIA, cg: PathCG) -> torch.Tensor:
    """Per-(ray, layer) continuum optical depth [R, NL, P].

    Linear T interpolation (clamped to the table range) at T_air; the pair
    density weight is x_a x_b int n^2 ds with x = u_species / u_air —
    differentiable in both the temperature and VMR retrieval states.
    """
    if cg.uu_air is None:
        raise ValueError("PathCG was built without uu_air: rebuild the "
                         "path with the current geometry module")
    tg = cia.T_grid
    n_T = tg.shape[0]
    f = (cg.T_air - tg[0]) / (tg[1] - tg[0])           # [R, NL]
    f = torch.clamp(f, 0.0, n_T - 1.000001)
    i0 = torch.floor(f).long()
    a = (f - i0).unsqueeze(-1)                         # [R, NL, 1]

    # Mole fractions from PRE-SCALED columns: a division's tangent squares
    # the denominator, and SI columns (~1e24 /m^2) square past float32's
    # range.  The exact power of two leaves the ratio bit-identical while
    # keeping the tangent's u_air^2 in normal range (without it the
    # reference's float32 temperature Jacobian had NaN entries).  The
    # empty-layer clamp squares safely too: (2^-40)^2 = 2^-80 stays normal
    # in float32, and empty layers give exactly 0 / clamp = 0.
    CG_SCALE = 2.0 ** -83
    u_air = torch.clamp(cg.u_air * CG_SCALE, min=2.0 ** -40)  # empty: x = 0
    dtau = 0.0
    for j in range(cia.n_pairs):
        x_a = cg.u[..., cia.pair_a[j]] * CG_SCALE / u_air     # [R, NL]
        x_b = cg.u[..., cia.pair_b[j]] * CG_SCALE / u_air
        w = (x_a * x_b * cg.uu_air).unsqueeze(-1)      # [R, NL, 1]
        k0 = cia.tables[j][i0]                         # [R, NL, P]
        k1 = cia.tables[j][i0 + 1]
        dtau = dtau + w * (k0 * (1.0 - a) + k1 * a)
    return dtau
