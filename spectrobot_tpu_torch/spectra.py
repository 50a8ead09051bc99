"""Spectral-object family (port of ``spectrobot_tpu.spectra``): a wavenumber
grid and a (possibly batched) value tensor with its physical ``kind``,
with arithmetic, unit conversions, band integration, regridding and
instrument-line-shape channelisation.

The values are a tensor on its device, in its dtype; the grid ``nu`` stays
a host float64 numpy array, as the CLI writes it.  :meth:`Spectrum.save_npz`
writes the reference's keys (``nu``, ``values``, ``kind``, ``units`` and
any extra arrays), so each package reads the other's files.

Kinds and units (wavenumber convention: cm^-1 everywhere):

    radiance                W m^-2 sr^-1 (cm^-1)^-1
    transmittance           dimensionless in [0, 1]
    optical_depth           dimensionless
    absorption_coeff        cm^2 molec^-1
    emission_coeff          radiance x absorption units
    brightness_temperature  K
    generic                 anything else (arithmetic of mixed kinds)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

KINDS = ("radiance", "transmittance", "optical_depth", "absorption_coeff",
         "emission_coeff", "brightness_temperature", "generic")

# Physical units per kind (wavenumber convention: cm^-1 everywhere).
UNITS = {
    "radiance": "W m^-2 sr^-1 (cm^-1)^-1",
    "transmittance": "1",
    "optical_depth": "1",
    "absorption_coeff": "cm^2 molec^-1",
    "emission_coeff": "W m^-2 sr^-1 (cm^-1)^-1 cm^2 molec^-1",
    "brightness_temperature": "K",
    "generic": "",
}


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class Spectrum:
    """A spectrum (or a batch of spectra) on a common wavenumber grid.

    values: [..., P] tensor (leading axes batch rays, layers, channels);
    nu: [P] host float64 grid [cm^-1]; kind: the physical tag (one of
    ``KINDS``).  Arithmetic requires grids of one shape."""

    __slots__ = ("nu", "values", "kind")

    def __init__(self, nu, values, kind: str = "generic"):
        if kind not in KINDS:
            raise ValueError(f"unknown spectrum kind {kind!r}; one of {KINDS}")
        self.nu = _host(nu).astype(np.float64)
        self.values = torch.as_tensor(values)
        self.kind = kind

    # -- basics ------------------------------------------------------------
    @property
    def n_points(self) -> int:
        return self.nu.shape[-1]

    @property
    def shape(self):
        return tuple(self.values.shape)

    @property
    def dtype(self):
        return self.values.dtype

    def _nu(self) -> torch.Tensor:
        """The grid as a tensor in the values' dtype and device."""
        return torch.as_tensor(self.nu, dtype=self.dtype,
                               device=self.values.device)

    def with_values(self, values, kind: Optional[str] = None) -> "Spectrum":
        return Spectrum(self.nu, values, self.kind if kind is None else kind)

    def __repr__(self):
        return (f"Spectrum(kind={self.kind!r}, n_points={self.n_points}, "
                f"shape={self.shape})")

    def _check_grid(self, other: "Spectrum"):
        if np.shape(self.nu) != np.shape(other.nu):
            raise ValueError(
                f"spectral grids differ: {np.shape(self.nu)} vs "
                f"{np.shape(other.nu)} — regrid with interp_to() first")

    @staticmethod
    def _combine_kind(a: "Spectrum", b) -> str:
        if isinstance(b, Spectrum) and b.kind != a.kind:
            return "generic"
        return a.kind

    def _binop(self, other, op, kind: Optional[str] = None) -> "Spectrum":
        if isinstance(other, Spectrum):
            self._check_grid(other)
            out = op(self.values, other.values)
        elif isinstance(other, np.ndarray):
            out = op(self.values, torch.as_tensor(
                other, device=self.values.device))
        else:
            out = op(self.values, other)
        return Spectrum(self.nu, out,
                        self._combine_kind(self, other) if kind is None
                        else kind)

    # -- arithmetic ------------------------------------------------------------
    def __add__(self, other):
        return self._binop(other, torch.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, torch.sub)

    def __rsub__(self, other):
        return self._binop(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._binop(other, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, torch.div)

    def __neg__(self):
        return self.with_values(-self.values)

    def __pow__(self, p):
        return self.with_values(self.values ** p, kind="generic")

    def __getitem__(self, sl) -> "Spectrum":
        """Spectral slice: sp[128:256] narrows the grid and values."""
        return Spectrum(self.nu[sl], self.values[..., sl], self.kind)

    # -- conversions -------------------------------------------------------------
    def to_transmittance(self) -> "Spectrum":
        """exp(-tau): optical depth -> transmittance."""
        if self.kind not in ("optical_depth", "generic"):
            raise ValueError(f"to_transmittance on kind {self.kind!r}")
        return Spectrum(self.nu, torch.exp(-self.values), "transmittance")

    def to_optical_depth(self) -> "Spectrum":
        """-log(t): transmittance -> optical depth (t clipped at 1e-300 in
        float64, 1e-38 otherwise)."""
        if self.kind not in ("transmittance", "generic"):
            raise ValueError(f"to_optical_depth on kind {self.kind!r}")
        tiny = 1e-300 if self.dtype == torch.float64 else 1e-38
        return Spectrum(self.nu, -torch.log(torch.clamp(self.values,
                                                        min=tiny)),
                        "optical_depth")

    def brightness_temperature(self) -> "Spectrum":
        """Inverse Planck per spectral point (radiance -> T_B [K])."""
        from spectrobot_tpu_torch.ops.planck import brightness_temperature
        if self.kind not in ("radiance", "generic"):
            raise ValueError(f"brightness_temperature on kind {self.kind!r}")
        return Spectrum(self.nu, brightness_temperature(self._nu(),
                                                        self.values),
                        "brightness_temperature")

    # -- calculus ----------------------------------------------------------------
    def integrate(self) -> torch.Tensor:
        """Trapezoid band integral over the grid (e.g. band radiance
        [W m^-2 sr^-1] from spectral radiance)."""
        return torch.trapezoid(self.values, self._nu(), dim=-1)

    def mean(self) -> torch.Tensor:
        return torch.mean(self.values, dim=-1)

    def interp_to(self, nu_new) -> "Spectrum":
        """Linear regrid onto ``nu_new`` (flat beyond the grid's ends, as
        ``jnp.interp``), in the values' dtype."""
        from spectrobot_tpu_torch.data.atmosphere import interp
        nu_new = _host(nu_new).astype(np.float64)
        dev = self.values.device
        x = torch.as_tensor(nu_new, device=dev)
        xp = torch.as_tensor(self.nu, device=dev)
        flat = self.values.reshape(-1, self.n_points).to(torch.float64)
        out = torch.func.vmap(lambda v: interp(x, xp, v))(flat)
        return Spectrum(nu_new, out.reshape(self.shape[:-1] + x.shape)
                        .to(self.dtype), self.kind)

    # -- instrument --------------------------------------------------------------
    def convolve_ils(self, nu_channels, fwhm: float,
                     shape: str = "gaussian",
                     cutoff_fwhm: float = 6.0) -> "Spectrum":
        """ILS channelisation: convolve with the instrument line shape and
        resample to the channels ``nu_channels`` (``ops.ils``: a matrix
        product, differentiable in the values)."""
        from spectrobot_tpu_torch.ops.ils import apply_ils, ils_matrix
        chans = _host(nu_channels).astype(np.float64)
        W = torch.as_tensor(ils_matrix(self.nu, chans, fwhm, shape=shape,
                                       cutoff_fwhm=cutoff_fwhm),
                            dtype=self.dtype, device=self.values.device)
        return Spectrum(chans, apply_ils(self.values, W), self.kind)

    # -- units -------------------------------------------------------------------
    @property
    def units(self) -> str:
        return UNITS[self.kind]

    # -- persistence -------------------------------------------------------------
    def save_npz(self, path: str, **extra) -> None:
        """Write the Spectrum with its kind and units (and any ``extra``
        arrays, e.g. tangent_heights_km) as npz: the CLI's output format,
        with the reference's keys."""
        np.savez(path, nu=self.nu, values=_host(self.values), kind=self.kind,
                 units=self.units, **{k: _host(v) for k, v in extra.items()})

    @staticmethod
    def load_npz(path: str, device="cpu") -> "Spectrum":
        """A Spectrum saved by :meth:`save_npz` (of either package), its
        values on ``device``; extra arrays are not read (``np.load``
        them)."""
        with np.load(path, allow_pickle=False) as d:
            return Spectrum(d["nu"], torch.as_tensor(d["values"],
                                                     device=device),
                            str(d["kind"]))


# convenience constructors ---------------------------------------------------

def radiance(nu, values) -> Spectrum:
    return Spectrum(nu, values, "radiance")


def optical_depth(nu, values) -> Spectrum:
    return Spectrum(nu, values, "optical_depth")


def transmittance(nu, values) -> Spectrum:
    return Spectrum(nu, values, "transmittance")


def absorption_coeff(nu, values) -> Spectrum:
    return Spectrum(nu, values, "absorption_coeff")


def emission_coeff(nu, values) -> Spectrum:
    return Spectrum(nu, values, "emission_coeff")
