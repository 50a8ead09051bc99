"""Planck function and non-LTE source weights (port of
``spectrobot_tpu.ops.planck``).

Non-LTE lines enter the opacity sum with two per-line weights built from
the population ratios r_u = n_u / n_u^LTE and r_l = n_l / n_l^LTE,

    w_abs_i = (r_l - r_u E_i) / (1 - E_i),      E_i = exp(-c2 nu0_i / T)
    w_em_i  = r_u,

so that the layer source function is S_nu = B_nu(T) k_em / k_abs; in LTE
both weights are 1 and S_nu = B_nu(T).
"""

from __future__ import annotations

import torch

from spectrobot_tpu_torch.constants import C1B, C2


def planck_nu(nu_cm1, T):
    """Spectral radiance B_nu(T) [W m^-2 sr^-1 (cm^-1)^-1], nu in cm^-1."""
    return C1B * nu_cm1 ** 3 / torch.expm1(C2 * nu_cm1 / T)


def brightness_temperature(nu_cm1, I):
    """Inverse Planck: T_B with B_nu(T_B) = I, nu in cm^-1,

        T_B = c2 nu / ln(1 + c1 nu^3 / I).

    Non-positive radiances map to 0 K (the log's argument is guarded by
    1e-300 in float64, 1e-38 otherwise)."""
    tiny = 1e-300 if I.dtype == torch.float64 else 1e-38
    ratio = C1B * nu_cm1 ** 3 / torch.clamp(I, min=tiny)
    return torch.where(I > 0.0, C2 * nu_cm1 / torch.log1p(ratio), 0.0)


def nlte_line_weights(nu0, T, r_lower, r_upper):
    """Per-line non-LTE weights (w_abs, w_em) from population ratios: nu0
    [L] line centers, T the kinetic temperature, r_lower/r_upper [L] the
    ratios of each line's lower and upper level (1 for LTE)."""
    E = torch.exp(-C2 * nu0 / T)
    w_abs = (r_lower - r_upper * E) / (1.0 - E)
    w_em = r_upper
    return w_abs, w_em


def vib_population_ratio(e_level_cm1, T_vib, T_kin):
    """Population ratio n/n^LTE of a vibrational level of energy E [cm-1]
    at the vibrational temperature T_vib:
    r = exp(-c2 E (1/T_vib - 1/T_kin))."""
    return torch.exp(-C2 * e_level_cm1 * (1.0 / T_vib - 1.0 / T_kin))
