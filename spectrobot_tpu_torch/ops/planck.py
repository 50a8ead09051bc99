"""Planck function (port of ``spectrobot_tpu.ops.planck.planck_nu``)."""

from __future__ import annotations

import torch

from spectrobot_tpu_torch.constants import C1B, C2


def planck_nu(nu_cm1, T):
    """Spectral radiance B_nu(T) [W m^-2 sr^-1 (cm^-1)^-1], nu in cm^-1."""
    return C1B * nu_cm1 ** 3 / torch.expm1(C2 * nu_cm1 / T)
