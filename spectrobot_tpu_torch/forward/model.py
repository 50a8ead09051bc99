"""Forward-model entry points (port of ``spectrobot_tpu.forward.model``).

``nadir_single_layer`` is the minimum end-to-end slice (acceptance config
1): S(T) -> Voigt -> k(nu) -> single-layer RT, through the single-state line
sum (``ops.opacity.cross_sections``: K3 for the radiance, K4 for its
``torch.func.jacfwd`` on the card).  The multi-layer limb/nadir models live
in :mod:`spectrobot_tpu_torch.forward.limb`.
"""

from __future__ import annotations

from typing import Optional

import torch

from spectrobot_tpu_torch.ops import opacity
from spectrobot_tpu_torch.ops.planck import planck_nu
from spectrobot_tpu_torch.ops.strengths import DeviceLines


def nadir_single_layer(nu_grid: torch.Tensor, lines: DeviceLines, T_layer,
                       p_layer_pa, column_m2, vmr_self, T_surface, *,
                       variant: str = "humlicek4",
                       cutoff_cm1: Optional[float] = 25.0, chunk: int = 256,
                       analytic_jvp=True, engine=None) -> torch.Tensor:
    """Radiance of one homogeneous layer over a blackbody surface (config 1):

        I(nu) = B_nu(T_surf) exp(-tau) + B_nu(T_layer) (1 - exp(-tau)),
        tau = sigma(nu) u,  u = column of the absorber [molec m^-2].

    nu_grid [P] [cm-1]; T_layer [K], p_layer_pa [Pa]; column_m2 [molec
    m^-2] (converted to cm^-2 per the constants' unit contract); vmr_self
    the absorber's volume mixing ratio (self-broadening); T_surface [K].
    ``analytic_jvp`` and ``engine`` as ``ops.opacity.cross_sections`` takes
    them.
    """
    sigma_abs, _ = opacity.cross_sections(
        nu_grid, lines, T_layer, p_layer_pa, p_self_pa=vmr_self * p_layer_pa,
        variant=variant, cutoff_cm1=cutoff_cm1, chunk=chunk,
        analytic_jvp=analytic_jvp, engine=engine)
    u_cm2 = column_m2 * 1.0e-4
    t = torch.exp(-sigma_abs * u_cm2)
    return (planck_nu(nu_grid, T_surface) * t
            + planck_nu(nu_grid, T_layer) * (1.0 - t))
