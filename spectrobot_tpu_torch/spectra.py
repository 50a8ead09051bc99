"""Spectrum record for the forward output (the part of
``spectrobot_tpu.spectra`` the forward writes).

:meth:`Spectrum.save_npz` writes the reference's keys (``nu``, ``values``,
``kind``, ``units`` and any extra arrays), so
``spectrobot_tpu.spectra.Spectrum.load_npz`` reads the port's output.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

UNITS = {"radiance": "W m^-2 sr^-1 (cm^-1)^-1"}


class Spectrum(NamedTuple):
    nu: np.ndarray        # [P] wavenumber grid [cm^-1]
    values: np.ndarray    # [..., P]
    kind: str

    @property
    def units(self) -> str:
        return UNITS[self.kind]

    def save_npz(self, path: str, **extra) -> None:
        np.savez(path, nu=np.asarray(self.nu),
                 values=np.asarray(self.values), kind=self.kind,
                 units=self.units,
                 **{k: np.asarray(v) for k, v in extra.items()})


def radiance(nu, values) -> Spectrum:
    return Spectrum(np.asarray(nu), np.asarray(values), "radiance")
