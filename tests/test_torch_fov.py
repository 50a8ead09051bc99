"""Field-of-view smearing of the PyTorch port (ops/ils.py fov_matrix and
apply_fov, build_forward's fov_V) against the JAX package, and the CIA
and FOV scenes of tests/test_golden_radiative.py against the float64
oracle at that file's tolerances, in float64 on the plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from golden import numpy_ref
from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.ops import ils as j_ils
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu.retrieval import state as jstate
from spectrobot_tpu_torch import interop
from spectrobot_tpu_torch.data.atmosphere import MARS
from spectrobot_tpu_torch.forward.geometry import limb_path_cg
from spectrobot_tpu_torch.forward.limb import limb_radiance
from spectrobot_tpu_torch.ops import ils as t_ils
from spectrobot_tpu_torch.ops.cia import CIATable, stage_cia
from spectrobot_tpu_torch.retrieval import state as tstate

from test_golden_radiative import _atm_arrays, _q_ratio_fn

torch.set_num_threads(1)

CPU = torch.device("cpu")
SPECIES = ["CO2"]
# tests/test_golden_radiative.py's tolerances against the oracle.
GOLDEN_RTOL, GOLDEN_ATOL_REL = 2e-4, 1e-7


def _numpy(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _pair(n_lev, z_top, ll):
    """The atmosphere and lines in both packages (float64)."""
    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=z_top)
    dl = j_stage(ll, [(2, 1)], dtype=jnp.float64)
    d = {k: np.asarray(getattr(atm, k)) for k in ("z", "p", "T", "n")}
    d["vmr"] = {k: np.asarray(v) for k, v in atm.vmr.items()}
    return (atm, dl, interop.atmosphere_from_numpy(d, device=CPU),
            interop.device_lines_from_numpy(_numpy(dl), device=CPU))


def test_fov_smearing_over_tangent_heights():
    """A smooth radiance ladder smeared into three FOVs: the port's matrix
    equals the reference's, and the smear averages locally."""
    h_fine = np.linspace(5e3, 60e3, 111)
    h_obs = np.array([15e3, 30e3, 45e3])
    V = t_ils.fov_matrix(h_fine, h_obs, fwhm_m=3e3)
    np.testing.assert_array_equal(V, j_ils.fov_matrix(h_fine, h_obs,
                                                      fwhm_m=3e3))
    I = np.outer(np.linspace(1.0, 0.1, 111), np.ones(17))
    out = t_ils.apply_fov(torch.as_tensor(I), torch.as_tensor(V)).numpy()
    assert out.shape == (3, 17)
    expect = np.interp(h_obs, h_fine, np.linspace(1.0, 0.1, 111))
    np.testing.assert_allclose(out[:, 0], expect, rtol=5e-3)
    ref = np.asarray(j_ils.apply_fov(jnp.asarray(I), jnp.asarray(V)))
    np.testing.assert_allclose(out, ref, rtol=1e-14)


def test_fov_in_build_forward():
    """build_forward's fov_V: the smeared forward equals the reference's
    and sits within the fine ladder's envelope."""
    atm, dl, tatm, tdl = _pair(7, 60e3, co2_15um_band(j_max=8))
    nu = np.linspace(660.0, 672.0, 150)
    h_fine = np.linspace(8e3, 50e3, 15)
    h_obs = np.array([15e3, 35e3])
    V = t_ils.fov_matrix(h_fine, h_obs, fwhm_m=6e3)
    jf = jstate.build_forward(atm, dl, jnp.asarray(nu), SPECIES, J_MARS,
                              tangent_heights_m=jnp.asarray(h_fine),
                              fov_V=jnp.asarray(V), n_sub=2)
    jx0, junr = jstate.flatten_state(jstate.make_state(atm, []))
    ref = np.asarray(jax.jit(lambda x: jf(junr(x)))(jx0))

    def fwd(fov_V):
        f = tstate.build_forward(tatm, tdl, torch.as_tensor(nu), SPECIES,
                                 MARS, tangent_heights_m=torch.as_tensor(
                                     h_fine), fov_V=fov_V, n_sub=2)
        x0, unr = tstate.flatten_state(tstate.make_state(tatm, []))
        return f(unr(x0)).numpy()

    y = fwd(torch.as_tensor(V))
    assert y.shape == (2 * 150,)
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-10 * ref.max())
    yf = fwd(None).reshape(15, 150)
    ys = y.reshape(2, 150)
    assert np.all(ys <= yf.max(axis=0) + 1e-12)
    assert np.all(ys >= yf.min(axis=0) - 1e-12)


def test_cia_limb_radiance_vs_oracle():
    """The continuum in the radiance, on the band shoulder: the port's
    limb forward with a staged CO2-CO2 table against the oracle's
    independent x_a x_b (int n^2 ds) k(T_air, nu) path."""
    atm, dl, tatm, tdl = _pair(13, 70e3, co2_15um_band(j_max=12))
    ll = co2_15um_band(j_max=12)
    nu = np.linspace(676.0, 700.0, 401)
    nu_t = np.linspace(650.0, 720.0, 141)
    T_t = np.array([120.0, 180.0, 240.0, 300.0])
    k_t = (1e-43 * np.exp(-0.5 * ((nu_t - 688.0) / 15.0) ** 2)[None, :]
           * (200.0 / T_t[:, None]))
    table = CIATable("CO2", "CO2", nu_t, T_t, k_t)
    cia = stage_cia(nu, [table], SPECIES, dtype=torch.float64, device=CPU)
    h_t = np.array([8e3, 25e3, 45e3])
    cg = limb_path_cg(tatm, SPECIES, torch.as_tensor(h_t), MARS, n_sub=4)
    tnu = torch.as_tensor(nu)
    got = limb_radiance(tnu, tdl, cg, cia=cia, cutoff_cm1=25.0).numpy()
    got_nocia = limb_radiance(tnu, tdl, cg, cutoff_cm1=25.0).numpy()
    z, p, T, n, vmr = _atm_arrays(atm)
    cia_args = (("CO2", "CO2"), table.nu_grid, table.T_grid, table.k)
    for r, ht in enumerate(h_t):
        ref = numpy_ref.limb_radiance(
            nu, {"CO2": ll}, z, p, T, n, vmr, J_MARS.radius_m, ht, SPECIES,
            _q_ratio_fn(ll), cutoff=25.0, n_sub=4, cia=cia_args)
        np.testing.assert_allclose(got[r], ref, rtol=GOLDEN_RTOL,
                                   atol=ref.max() * GOLDEN_ATOL_REL,
                                   err_msg=f"ray {r}")
    assert np.max(np.abs(got - got_nocia)) > 1e-3 * got.max()


def test_fov_ladder_vs_oracle():
    """FOV smearing: the port's fov_matrix and apply_fov over a fine
    tangent ladder against the oracle's own quadrature weights applied to
    oracle per-ray radiances."""
    atm, dl, tatm, tdl = _pair(13, 70e3, co2_15um_band(j_max=12))
    ll = co2_15um_band(j_max=12)
    nu = np.linspace(655.0, 672.0, 401)
    h_fine = np.linspace(6e3, 46e3, 11)
    h_obs = np.array([16e3, 30e3])
    fwhm = 6e3
    cg = limb_path_cg(tatm, SPECIES, torch.as_tensor(h_fine), MARS, n_sub=3)
    V = torch.as_tensor(t_ils.fov_matrix(h_fine, h_obs, fwhm))
    got = t_ils.apply_fov(limb_radiance(torch.as_tensor(nu), tdl, cg,
                                        cutoff_cm1=25.0), V).numpy()
    z, p, T, n, vmr = _atm_arrays(atm)
    I_fine = np.stack([
        numpy_ref.limb_radiance(nu, {"CO2": ll}, z, p, T, n, vmr,
                                J_MARS.radius_m, ht, SPECIES,
                                _q_ratio_fn(ll), cutoff=25.0, n_sub=3)
        for ht in h_fine])
    ref = numpy_ref.fov_weights(h_fine, h_obs, fwhm) @ I_fine
    np.testing.assert_allclose(got, ref, rtol=GOLDEN_RTOL,
                               atol=ref.max() * GOLDEN_ATOL_REL)
    nearest = I_fine[np.abs(h_fine[None, :] - h_obs[:, None]).argmin(1)]
    assert np.max(np.abs(ref - nearest)) > 1e-3 * ref.max()
