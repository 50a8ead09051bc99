"""Atmosphere model and planets (port of ``spectrobot_tpu.data.atmosphere``:
the 1-D :class:`Atmosphere`, the latitude x altitude :class:`Atmosphere2D`,
and the standard Mars/Titan profiles and the zonal Mars climatology).

Profiles are built host-side in float64 numpy and held as float64 tensors on
the device; interpolation in altitude is plain torch (:func:`interp`, the
semantics of ``jnp.interp``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from spectrobot_tpu_torch.constants import AMU, K_BOLTZ


@dataclasses.dataclass(frozen=True)
class Planet:
    name: str
    radius_m: float        # mean radius [m]
    g0: float              # surface gravity [m/s^2]
    mu_amu: float          # mean molecular mass [amu]


MARS = Planet("Mars", 3389.5e3, 3.711, 43.34)
TITAN = Planet("Titan", 2574.7e3, 1.352, 28.0)
EARTH = Planet("Earth", 6371.0e3, 9.80665, 28.9647)
PLANETS: Dict[str, Planet] = {p.name.lower(): p for p in (MARS, TITAN, EARTH)}


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """One-dimensional linear interpolation with flat extension, as
    ``numpy.interp`` / ``jnp.interp`` (xp ascending)."""
    dt = torch.promote_types(x.dtype, xp.dtype)
    x, xp = x.to(dt), xp.to(dt)
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    # numpy.spacing(eps) of the working dtype is eps**2.
    dx0 = torch.abs(dx) <= torch.finfo(dt).eps ** 2
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@dataclasses.dataclass(frozen=True)
class Atmosphere:
    """1-D atmosphere on a fixed altitude grid (level quantities, [n_lev],
    SI units): z [m], p [Pa], T [K], n [m^-3], vmr {name: [n_lev]}."""

    z: torch.Tensor
    p: torch.Tensor
    T: torch.Tensor
    n: torch.Tensor
    vmr: Dict[str, torch.Tensor]

    @property
    def n_lev(self) -> int:
        return int(self.z.shape[0])

    def with_temperature(self, T_new: torch.Tensor) -> "Atmosphere":
        """Replace T and rehydrate the density at fixed pressure (ideal
        gas), as the retrieval perturbs the temperature profile.

        Computed as (p/T)/k_B, not p/(k_B T): forward-mode AD of a division
        squares its denominator, and (k_B T)^2 ~ 1e-41 underflows float32;
        T carries the tangents, so the tangent-bearing denominator must stay
        in normal range."""
        n_new = (self.p / T_new) * (1.0 / K_BOLTZ)
        return dataclasses.replace(self, T=T_new, n=n_new)

    def with_vmr(self, name: str, vmr_new: torch.Tensor) -> "Atmosphere":
        vmr = dict(self.vmr)
        vmr[name] = vmr_new
        return dataclasses.replace(self, vmr=vmr)

    def to(self, dtype: torch.dtype) -> "Atmosphere":
        """The same profiles in ``dtype`` (the retrieval's compute dtype)."""
        return Atmosphere(z=self.z.to(dtype), p=self.p.to(dtype),
                          T=self.T.to(dtype), n=self.n.to(dtype),
                          vmr={k: v.to(dtype) for k, v in self.vmr.items()})

    def interp_T(self, z_q: torch.Tensor) -> torch.Tensor:
        return interp(z_q, self.z, self.T)

    def interp_logp(self, z_q: torch.Tensor) -> torch.Tensor:
        return torch.exp(interp(z_q, self.z, torch.log(self.p)))

    def interp_n(self, z_q: torch.Tensor) -> torch.Tensor:
        return torch.exp(interp(z_q, self.z, torch.log(self.n)))

    def interp_vmr(self, name: str, z_q: torch.Tensor) -> torch.Tensor:
        return interp(z_q, self.z, self.vmr[name])

    @staticmethod
    def from_numpy(z, p, T, n, vmr, *, device) -> "Atmosphere":
        t = lambda a: torch.tensor(np.asarray(a), device=device)
        return Atmosphere(z=t(z), p=t(p), T=t(T), n=t(n),
                          vmr={k: t(v) for k, v in vmr.items()})

    @staticmethod
    def load_npz(path: str, *, device) -> "Atmosphere":
        """Read the reference's Atmosphere .npz layout (z, p, T, n,
        vmr_<name>)."""
        with np.load(path) as z:
            return Atmosphere.from_numpy(
                z["z"], z["p"], z["T"], z["n"],
                {k[4:]: z[k] for k in z.files if k.startswith("vmr_")},
                device=device)


@dataclasses.dataclass(frozen=True)
class Atmosphere2D:
    """Latitude x altitude atmosphere (level quantities, SI units):
    lat_deg [NLAT] ascending, z [NZ], p/T/n [NLAT, NZ], vmr {name: [NLAT,
    NZ]}.  :meth:`at_lat` slices it at an observation latitude into a 1-D
    :class:`Atmosphere`, so one climatology serves a limb campaign."""

    lat_deg: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    T: torch.Tensor
    n: torch.Tensor
    vmr: Dict[str, torch.Tensor]

    @property
    def n_lat(self) -> int:
        return int(self.lat_deg.shape[0])

    def at_lat(self, lat_q) -> Atmosphere:
        """The 1-D atmosphere at latitude ``lat_q`` [deg] (a number or a
        tensor; clamped to the grid): linear in T and the VMRs, log-linear
        in p and n, differentiable in ``lat_q``.  On a grid latitude the
        slice takes the cell below it at weight 1, and its derivative is
        that cell's slope (the reference's clip passes half of it there)."""
        lat_q = torch.as_tensor(lat_q, dtype=self.lat_deg.dtype,
                                device=self.lat_deg.device)
        idx = torch.clamp(torch.searchsorted(self.lat_deg, lat_q) - 1, 0,
                          self.n_lat - 2)
        lo, hi = self.lat_deg[idx], self.lat_deg[idx + 1]
        w = torch.clamp((lat_q - lo) / (hi - lo), 0.0, 1.0)

        def mix(a):
            return (1.0 - w) * a[idx] + w * a[idx + 1]

        def mix_log(a):
            return torch.exp((1.0 - w) * torch.log(a[idx])
                             + w * torch.log(a[idx + 1]))

        return Atmosphere(z=self.z, p=mix_log(self.p), T=mix(self.T),
                          n=mix_log(self.n),
                          vmr={k: mix(v) for k, v in self.vmr.items()})

    @staticmethod
    def from_profiles(lats_deg, atms) -> "Atmosphere2D":
        """Stack 1-D atmospheres on one altitude grid into a climatology."""
        z0 = atms[0].z
        for a in atms[1:]:
            if not torch.equal(a.z, z0):
                raise ValueError("the profiles' altitude grids differ")
        return Atmosphere2D(
            lat_deg=torch.as_tensor(np.asarray(lats_deg, np.float64),
                                    device=z0.device),
            z=z0, p=torch.stack([a.p for a in atms]),
            T=torch.stack([a.T for a in atms]),
            n=torch.stack([a.n for a in atms]),
            vmr={k: torch.stack([a.vmr[k] for a in atms])
                 for k in sorted(atms[0].vmr)})

    def save_npz(self, path: str) -> None:
        """The reference's layout (lat_deg, z, p, T, n, vmr_<name>)."""
        host = lambda t: t.detach().cpu().numpy()
        arrays = {k: host(getattr(self, k))
                  for k in ("lat_deg", "z", "p", "T", "n")}
        arrays.update({f"vmr_{k}": host(v) for k, v in self.vmr.items()})
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load_npz(path: str, *, device) -> "Atmosphere2D":
        with np.load(path) as z:
            t = lambda k: torch.tensor(z[k], device=device)
            return Atmosphere2D(
                lat_deg=t("lat_deg"), z=t("z"), p=t("p"), T=t("T"), n=t("n"),
                vmr={k[4:]: t(k) for k in z.files if k.startswith("vmr_")})


def hydrostatic_atmosphere(planet: Planet, z: np.ndarray, T_of_z,
                           p_surface: float, vmr: Dict[str, np.ndarray], *,
                           device) -> Atmosphere:
    """An atmosphere in hydrostatic equilibrium, integrated host-side in
    float64 with midpoint steps: dp/dz = -p mu g(z) / (k T(z)).
    ``T_of_z`` is a callable T(z) or an array on ``z``."""
    z = np.asarray(z, dtype=np.float64)
    T = np.asarray(T_of_z(z) if callable(T_of_z) else T_of_z,
                   dtype=np.float64)
    mu = planet.mu_amu * AMU
    p = np.empty_like(z)
    p[0] = p_surface
    for i in range(1, z.shape[0]):
        dz = z[i] - z[i - 1]
        zm = 0.5 * (z[i] + z[i - 1])
        g = planet.g0 * (planet.radius_m / (planet.radius_m + zm)) ** 2
        Tm = 0.5 * (T[i] + T[i - 1])
        H = K_BOLTZ * Tm / (mu * g)
        p[i] = p[i - 1] * np.exp(-dz / H)
    n = p / (K_BOLTZ * T)
    vmr = {k: np.broadcast_to(np.asarray(v, dtype=np.float64), z.shape).copy()
           for k, v in vmr.items()}
    return Atmosphere.from_numpy(z, p, T, n, vmr, device=device)


def titan_standard_atmosphere(n_lev: int = 51, z_top: float = 600e3, *,
                              device) -> Atmosphere:
    """A smooth Titan-like reference atmosphere (N2-dominated, CH4/CO)."""
    z = np.linspace(0.0, z_top, n_lev)

    def T_of_z(zz):
        # ~94 K surface, ~70 K tropopause near 40 km, ~170 K aloft.
        return (94.0 - 24.0 * np.clip(zz / 40e3, 0.0, 1.0)
                + 100.0 * np.clip((zz - 40e3) / 360e3, 0.0, 1.0))

    vmr = {
        "N2": np.full(n_lev, 0.943),
        "CH4": 0.014 + 0.034 * np.exp(-z / 30e3),
        "CO": np.full(n_lev, 4.7e-5),
        "C2H2": 3.0e-6 * np.clip(z / 200e3, 0.0, 1.0) + 1e-9,
    }
    return hydrostatic_atmosphere(TITAN, z, T_of_z, p_surface=1.467e5,
                                  vmr=vmr, device=device)


def mars_standard_atmosphere(n_lev: int = 51, z_top: float = 100e3, *,
                             device) -> Atmosphere:
    """A smooth Mars-like reference atmosphere (CO2-dominated)."""
    z = np.linspace(0.0, z_top, n_lev)

    def T_of_z(zz):
        # ~210 K surface falling to ~140 K aloft, mild mesospheric bump.
        return (145.0 + 65.0 * np.exp(-zz / 35e3)
                + 8.0 * np.exp(-((zz - 70e3) / 12e3) ** 2))

    vmr = {
        "CO2": np.full(n_lev, 0.9532),
        "CO": np.full(n_lev, 7.0e-4),
        "H2O": 2.0e-4 * np.exp(-z / 20e3),
        "N2": np.full(n_lev, 0.027),
    }
    return hydrostatic_atmosphere(MARS, z, T_of_z, p_surface=610.0, vmr=vmr,
                                  device=device)


def mars_zonal_atmosphere(n_lat: int = 7, n_lev: int = 51,
                          z_top: float = 100e3, *, device) -> Atmosphere2D:
    """A smooth zonal-mean Mars climatology: equator-to-pole cooling (~30 K
    at the surface), drier and lower-pressure high latitudes."""
    lats = np.linspace(-90.0, 90.0, n_lat)
    z = np.linspace(0.0, z_top, n_lev)
    atms = []
    for lat in lats:
        cosl = np.cos(np.radians(lat))
        dT = 30.0 * (cosl - 1.0)            # 0 at the equator, -30 K at poles

        def T_of_z(zz, dT=dT):
            return (145.0 + dT * np.exp(-zz / 25e3)
                    + 65.0 * np.exp(-zz / 35e3)
                    + 8.0 * np.exp(-((zz - 70e3) / 12e3) ** 2))

        vmr = {
            "CO2": np.full(n_lev, 0.9532),
            "CO": np.full(n_lev, 7.0e-4),
            "H2O": (0.3 + 0.7 * cosl) * 2.0e-4 * np.exp(-z / 20e3),
            "N2": np.full(n_lev, 0.027),
        }
        atms.append(hydrostatic_atmosphere(
            MARS, z, T_of_z, p_surface=610.0 * (0.85 + 0.15 * cosl), vmr=vmr,
            device=device))
    return Atmosphere2D.from_profiles(lats, atms)
