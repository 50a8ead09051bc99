"""Synthetic line lists and scenes for tests, demos, and benchmarks.

No HITRAN catalog ships in this image (no network egress; the reference mount
is empty — SURVEY.md section 0).  These generators produce physically shaped
vibration-rotation bands (P/R branch structure from a rigid-rotor model) whose
records round-trip through the real .par parser, so every acceptance config
(BASELINE.json configs 1-5) exercises the true ingestion path with realistic
line-density, strength-contrast and width statistics.  Dropping in a real
``.par`` file requires no code change.
"""

from __future__ import annotations

from typing import List

import numpy as np

from spectrobot_tpu_torch.constants import C2, T_REF
from spectrobot_tpu_torch.data.hitran import LineList, format_par_record, parse_par_text
from spectrobot_tpu_torch.data.molparams import MOLECULES


def rovib_band(
    mol_id: int,
    iso_id: int,
    nu_band: float,
    s_band: float,
    b_rot: float,
    j_max: int = 80,
    gamma_air: float = 0.07,
    gamma_self: float = 0.09,
    n_air: float = 0.7,
    delta_air: float = -0.002,
    band_quanta_u: str = "v1",
    band_quanta_l: str = "v0",
) -> LineList:
    """Generate one vibration-rotation band as a LineList.

    P branch: nu = nu_band - 2B*J (J = 1..Jmax);  R branch: nu = nu_band +
    2B*(J+1) (J = 0..Jmax).  Strengths follow the rigid-rotor Boltzmann
    envelope at 296 K, normalised so the band sums to ``s_band``
    [cm-1/(molec cm-2)].  Lower-state energies E'' = B*J*(J+1).
    """
    J_p = np.arange(1, j_max + 1)
    J_r = np.arange(0, j_max + 1)
    nu_p = nu_band - 2.0 * b_rot * J_p
    nu_r = nu_band + 2.0 * b_rot * (J_r + 1)
    e_p = b_rot * J_p * (J_p + 1.0)
    e_r = b_rot * J_r * (J_r + 1.0)
    # Hoenl-London-ish line factors: P ~ J, R ~ J+1, Boltzmann on E''.
    w_p = J_p * np.exp(-C2 * e_p / T_REF)
    w_r = (J_r + 1.0) * np.exp(-C2 * e_r / T_REF)
    norm = s_band / (w_p.sum() + w_r.sum())

    nu0 = np.concatenate([nu_p, nu_r])
    sw = norm * np.concatenate([w_p, w_r])
    elower = np.concatenate([e_p, e_r])
    jlow = np.concatenate([J_p, J_r])
    n = nu0.shape[0]

    recs: List[str] = []
    for i in range(n):
        recs.append(
            format_par_record(
                mol_id, iso_id, float(nu0[i]), float(sw[i]), a=1.0,
                gamma_air=gamma_air, gamma_self=gamma_self,
                elower=float(elower[i]), n_air=n_air, delta_air=delta_air,
                gq_u=band_quanta_u, gq_l=band_quanta_l,
                lq_u=f"J{int(jlow[i])}u", lq_l=f"J{int(jlow[i])}l",
                gp=2.0 * jlow[i] + 1.0, gpp=2.0 * jlow[i] + 1.0,
            )
        )
    return parse_par_text("\n".join(recs))


def co2_15um_band(j_max: int = 60) -> LineList:
    """CO2 nu2 fundamental near 667 cm-1 (15 um) — config 1/2 workload."""
    return rovib_band(
        mol_id=2, iso_id=1, nu_band=667.38, s_band=8.0e-18, b_rot=0.3902,
        j_max=j_max, gamma_air=0.07, gamma_self=0.09, n_air=0.7,
        band_quanta_u="0110", band_quanta_l="0000",
    )


def co2_43um_band(j_max: int = 60) -> LineList:
    """CO2 nu3 fundamental near 2349 cm-1 (4.3 um) — config 3 (non-LTE)."""
    return rovib_band(
        mol_id=2, iso_id=1, nu_band=2349.14, s_band=9.5e-17, b_rot=0.3871,
        j_max=j_max, gamma_air=0.07, gamma_self=0.095, n_air=0.7,
        band_quanta_u="0001", band_quanta_l="0000",
    )


def co2_43um_hot_band(j_max: int = 50) -> LineList:
    """CO2 4.3 um first hot band (0111 <- 0110) — adds non-LTE structure."""
    ll = rovib_band(
        mol_id=2, iso_id=1, nu_band=2336.63, s_band=8.0e-18, b_rot=0.3871,
        j_max=j_max, gamma_air=0.07, gamma_self=0.095, n_air=0.7,
        band_quanta_u="0111", band_quanta_l="0110",
    )
    # Hot-band lower state sits on the 667 cm-1 bending level.
    ll.elower[:] = ll.elower + 667.38
    return ll


def co_fundamental(j_max: int = 40) -> LineList:
    """CO 1-0 fundamental near 2143 cm-1 — config 5 species."""
    return rovib_band(
        mol_id=5, iso_id=1, nu_band=2143.27, s_band=9.7e-18, b_rot=1.9313,
        j_max=j_max, gamma_air=0.06, gamma_self=0.065, n_air=0.69,
        band_quanta_u="1", band_quanta_l="0",
    )


def h2o_band(nu_band: float = 2300.0, j_max: int = 30) -> LineList:
    """A pseudo-H2O band (irregular rotor approximated as rigid rotor) for
    multi-species retrievals (config 5)."""
    return rovib_band(
        mol_id=1, iso_id=1, nu_band=nu_band, s_band=2.0e-19, b_rot=9.28,
        j_max=j_max, gamma_air=0.08, gamma_self=0.35, n_air=0.68,
        band_quanta_u="010", band_quanta_l="000",
    )


def random_lines(
    n_lines: int,
    nu_min: float,
    nu_max: float,
    seed: int = 0,
    mol_id: int = 2,
    iso_id: int = 1,
) -> LineList:
    """Large random line list for kernel benchmarks (uniform centers,
    log-uniform strengths) — built directly as columns, skipping the text
    round trip, so multi-million-line benchmark lists stay cheap to make."""
    rng = np.random.default_rng(seed)
    n = n_lines
    mass = MOLECULES[mol_id].isotopologues[iso_id].mass_amu
    cols = {
        "nu0": rng.uniform(nu_min, nu_max, n),
        "sw": 10.0 ** rng.uniform(-24.0, -18.0, n),
        "a_einstein": np.ones(n),
        "gamma_air": rng.uniform(0.04, 0.1, n),
        "gamma_self": rng.uniform(0.05, 0.12, n),
        "elower": rng.uniform(0.0, 3000.0, n),
        "n_air": rng.uniform(0.5, 0.8, n),
        "delta_air": rng.uniform(-0.01, 0.002, n),
        "gp": np.ones(n),
        "gpp": np.ones(n),
        "mass_amu": np.full(n, mass),
        "mol_id": np.full(n, mol_id, dtype=np.int32),
        "iso_id": np.full(n, iso_id, dtype=np.int32),
    }
    return LineList.from_columns(cols)
