"""Line-strength T-scaling and line widths (port of
``spectrobot_tpu.ops.strengths``).

Line parameter tensors have shape [L]; thermodynamic state (T, p, ...) may be
a scalar, an [L] tensor or a batch [..., L] of per-line states.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spectrobot_tpu_torch.constants import AMU, ATM, C2, C_LIGHT, K_BOLTZ, LN2, T_REF


class DeviceLines(NamedTuple):
    """Struct-of-arrays line parameters on the device (compute dtype).

    ``q_tbl``/``q_tgrid`` hold the packed partition-sum tables (one row per
    species) and ``species_idx`` maps each line to its row.

    PRECISION: ``nu0`` is an OFFSET from ``nu_ref`` (subtracted host-side in
    float64): a float32 absolute wavenumber at 650 cm-1 quantises at ~3e-5
    cm-1, comparable to Doppler widths.  Quantities that need the absolute
    wavenumber use ``nu0_abs``, where float32 rounding is harmless.
    """

    nu0: torch.Tensor          # [L] line centers, OFFSET from nu_ref [cm-1]
    sw: torch.Tensor           # [L] strength at 296 K
    elower: torch.Tensor       # [L] lower-state energy [cm-1]
    gamma_air: torch.Tensor    # [L]
    gamma_self: torch.Tensor   # [L]
    n_air: torch.Tensor        # [L]
    delta_air: torch.Tensor    # [L]
    mass_amu: torch.Tensor     # [L]
    species_idx: torch.Tensor  # [L] int64 row into q_tbl / species axis
    level_upper: torch.Tensor  # [L] int64 non-LTE level index (-1 = LTE)
    level_lower: torch.Tensor  # [L] int64
    q_tbl: torch.Tensor        # [n_species, n_T] partition sums
    q_tgrid: torch.Tensor      # [n_T] temperature grid of q_tbl
    nu_ref: torch.Tensor       # scalar wavenumber origin [cm-1]

    @property
    def n_lines(self) -> int:
        return int(self.nu0.shape[0])

    @property
    def nu0_abs(self) -> torch.Tensor:
        return self.nu0 + self.nu_ref


def device_lines_from_linelist(ll, species, *, device, dtype=torch.float32,
                               nu_ref: float = None) -> DeviceLines:
    """Stage a host LineList on ``device``.

    ``species`` is an ordered list of (mol_id, iso_id) defining the species
    axis; lines of other species are dropped.  ``nu_ref`` (default: midpoint
    of the line range, rounded) rebases line centers to offsets.
    """
    from spectrobot_tpu_torch.data import tips

    key = {tuple(s): i for i, s in enumerate(species)}
    pair = np.stack([ll.mol_id, ll.iso_id], axis=1)
    sp = np.array([key.get((int(m), int(i)), -1) for m, i in pair],
                  dtype=np.int64)
    idx = np.nonzero(sp >= 0)[0]

    if nu_ref is None:
        nu_ref = (float(np.round(0.5 * (ll.nu0[idx].min() + ll.nu0[idx].max())))
                  if len(idx) else 0.0)

    def real(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def index(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=device)

    q_tbl = tips.pack_q_tables([tuple(s) for s in species])
    return DeviceLines(
        nu0=real(ll.nu0[idx] - nu_ref),
        sw=real(ll.sw[idx]),
        elower=real(ll.elower[idx]),
        gamma_air=real(ll.gamma_air[idx]),
        gamma_self=real(ll.gamma_self[idx]),
        n_air=real(ll.n_air[idx]),
        delta_air=real(ll.delta_air[idx]),
        mass_amu=real(ll.mass_amu[idx]),
        species_idx=index(sp[idx]),
        level_upper=index(ll.level_upper[idx]),
        level_lower=index(ll.level_lower[idx]),
        q_tbl=real(q_tbl),
        q_tgrid=real(tips.T_GRID),
        nu_ref=real(nu_ref),
    )


def partition_ratio(lines: DeviceLines, T) -> torch.Tensor:
    """Q(T_ref)/Q(T) per line via the packed tables; T is a scalar or
    broadcasts against [..., L]."""
    tgrid = lines.q_tgrid
    dt_grid = tgrid[1] - tgrid[0]
    f = (T - tgrid[0]) / dt_grid
    f = torch.clamp(f, 0.0, tgrid.shape[0] - 1.000001)
    i0 = torch.floor(f).to(torch.int64)
    frac = f - i0
    rows = lines.q_tbl[lines.species_idx]          # [L, n_T]
    # Gather the two bracketing samples along the T axis, per line.
    shape = torch.broadcast_shapes(i0.shape, lines.nu0.shape)
    i0 = torch.broadcast_to(i0, shape)
    line = torch.arange(lines.n_lines, device=tgrid.device)
    qT = rows[line, i0] * (1 - frac) + rows[line, i0 + 1] * frac
    # Q at the reference temperature (static index).
    f_ref = (T_REF - tgrid[0]) / dt_grid
    i_ref = int(torch.floor(f_ref))
    fr_ref = f_ref - i_ref
    q_ref = rows[:, i_ref] * (1 - fr_ref) + rows[:, i_ref + 1] * fr_ref
    return q_ref / qT


def line_strength(lines: DeviceLines, T) -> torch.Tensor:
    """S(T) per line [cm-1/(molec cm-2)], the HITRAN scaling law."""
    qr = partition_ratio(lines, T)
    boltz = torch.exp(-C2 * lines.elower * (1.0 / T - 1.0 / T_REF))
    nu_abs = lines.nu0_abs
    stim = ((1.0 - torch.exp(-C2 * nu_abs / T))
            / (1.0 - torch.exp(-C2 * nu_abs / T_REF)))
    return lines.sw * qr * boltz * stim


def doppler_hwhm(lines: DeviceLines, T) -> torch.Tensor:
    """Doppler HWHM [cm-1]: alpha_D = nu0/c * sqrt(2 ln2 kT / m)."""
    m_kg = lines.mass_amu * AMU
    return lines.nu0_abs / C_LIGHT * torch.sqrt(2.0 * LN2 * K_BOLTZ * T / m_kg)


def lorentz_hwhm(lines: DeviceLines, T, p_pa, p_self_pa=0.0) -> torch.Tensor:
    """Pressure-broadened HWHM [cm-1], pressures converted to atm."""
    p_atm = p_pa / ATM
    ps_atm = p_self_pa / ATM
    return (T_REF / T) ** lines.n_air * (
        lines.gamma_air * (p_atm - ps_atm) + lines.gamma_self * ps_atm)


def pressure_shifted_center(lines: DeviceLines, p_pa) -> torch.Tensor:
    """nu0' = nu0 + delta_air * p[atm], in OFFSET coordinates [cm-1]."""
    return lines.nu0 + lines.delta_air * (p_pa / ATM)
