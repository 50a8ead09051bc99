"""Sub-Lorentzian wing-correction (chi) factors (port of
``spectrobot_tpu.ops.chi``).

CO2-CO2 line wings fall off faster than Lorentzian; Mars/Venus CO2
radiative-transfer codes multiply the far wing by an empirical chi factor
(Perrin & Hartmann 1989-style piecewise exponentials).  Within the wing
cutoff (<= ``CHI_MAX_CUTOFF``) only the first Perrin-Hartmann segment
applies, so chi reduces to one per-line exponential slope

    chi(|dnu|) = exp(-b(T) * max(|dnu| - DELTA1, 0)),   DELTA1 = 3 cm^-1

with the temperature-dependent slope b(T) evaluated per line from each
state's per-species temperature in the stage-1 prologue
(``ops.opacity.line_kernel_inputs``): b rides the kernels as one more
per-line array (0 = chi off for that line, exactly 1.0).

Jacobian convention: the analytic basis tangent and its transpose treat
chi as constant (frozen-chi), exact for the amplitude, width and y
derivatives (chi scales all four basis rows); the d(chi)/d(nu_c) and
d(chi)/dT-through-b terms are dropped, O(b / scale_x) ~ 1e-4 of the
retained line-position term.

Coefficients for "co2_mars": the first-segment slope of the Perrin &
Hartmann (1989, JQSRT 42, 311) CO2-CO2 chi factor,
b1(T) = alpha1 + beta1 exp(-eps1 T) with alpha1 = 0.0888, beta1 = -0.160,
eps1 = 0.00410; the segment boundaries are 3 and 30 cm^-1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# First-segment knot [cm^-1]: chi = 1 inside |dnu| <= DELTA1.
CHI_DELTA1 = 3.0

# The single-slope form is exact only while the wing cutoff stays inside
# the second P&H segment boundary.
CHI_MAX_CUTOFF = 30.0


class ChiProfile(NamedTuple):
    """One sub-Lorentzian wing profile: applies to ``species`` (molecule
    name); slope b(T) = max(alpha + beta * exp(-eps * T), 0) [1/cm^-1]."""
    species: str
    alpha: float
    beta: float
    eps: float

    def slope(self, T):
        """b(T) >= 0 for a tensor T (in its dtype) or a number (in
        float64)."""
        if not isinstance(T, torch.Tensor):
            T = torch.as_tensor(T, dtype=torch.float64)
        return torch.clamp(self.alpha + self.beta * torch.exp(-self.eps * T),
                           min=0.0)


CHI_PROFILES = {
    # Perrin & Hartmann (1989) CO2-CO2, first segment (3-30 cm^-1).
    "co2_mars": ChiProfile("CO2", 0.0888, -0.160, 0.00410),
}


def chi_slopes_for_lines(profile: Optional[ChiProfile], lines, T_line):
    """Per-line chi slopes [L] for a line batch at per-line temperatures
    ``T_line`` (0 where the profile does not apply), or None without a
    profile.  ``lines.mol_of_line`` (a molecule id per line) selects the
    species; the profile's species name is resolved through
    ``data.molparams``."""
    if profile is None:
        return None
    from spectrobot_tpu_torch.data.molparams import molecule_by_name
    mol_id = molecule_by_name(profile.species).mol_id
    mask = torch.as_tensor(lines.mol_of_line) == mol_id
    b = profile.slope(T_line)
    return torch.where(mask.to(b.device), b, torch.zeros_like(b))


def chi_factor_np(dnu_abs, b):
    """Float64 NumPy chi factor for oracles and tests (the same formula)."""
    return np.exp(-np.asarray(b) * np.maximum(np.asarray(dnu_abs)
                                              - CHI_DELTA1, 0.0))
