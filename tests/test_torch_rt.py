"""The line-of-sight integrator of the PyTorch port
(spectrobot_tpu_torch/forward/rt.py): tests/test_rt.py's checks on the
port (the sequential oracle, the opaque and transparent limits, batched
rays, the isothermal nadir cavity and the grey surface), and
radiance_along_ray and transmittance against the reference's on the same
numpy inputs."""

import jax.numpy as jnp
import numpy as np
import torch

from golden import numpy_ref
from spectrobot_tpu.forward import rt as jrt
from spectrobot_tpu_torch.forward.rt import (
    layer_path_radiance, radiance_along_ray, transmittance)

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_matches_sequential_oracle():
    rng = np.random.default_rng(3)
    dtau = rng.uniform(0.0, 1.5, (12, 64))
    src = rng.uniform(0.0, 2.0, (12, 64))
    bg = rng.uniform(0.0, 1.0, 64)
    ref = numpy_ref.radiance_along_ray(dtau, src, bg)
    got = radiance_along_ray(_t(dtau), _t(src), _t(bg))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


def test_isothermal_opaque_is_source():
    got = radiance_along_ray(torch.full((20, 8), 10.0, dtype=torch.float64),
                             torch.full((20, 8), 3.14, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), 3.14, rtol=1e-10)


def test_transparent_passes_background():
    dtau = torch.zeros((5, 8), dtype=torch.float64)
    got = radiance_along_ray(dtau, torch.ones_like(dtau),
                             torch.full((8,), 7.0, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), 7.0, rtol=1e-12)
    np.testing.assert_allclose(transmittance(dtau).numpy(), 1.0)


def test_batched_rays():
    rng = np.random.default_rng(4)
    dtau = rng.uniform(0, 1, (3, 7, 16))   # [ray, seg, nu]
    src = rng.uniform(0, 1, (3, 7, 16))
    got = radiance_along_ray(_t(dtau), _t(src)).numpy()
    for r in range(3):
        np.testing.assert_allclose(
            got[r], numpy_ref.radiance_along_ray(dtau[r], src[r]),
            rtol=1e-12)


def test_matches_jax_and_the_layer_form():
    """radiance_along_ray and transmittance against the reference's (float64
    and float32), and layer_path_radiance equal to radiance_along_ray of
    the gathered segments."""
    rng = np.random.default_rng(5)
    dtau = rng.uniform(0.0, 2.0, (2, 9, 40))
    src = rng.uniform(0.0, 3.0, (2, 9, 40))
    bg = rng.uniform(0.0, 1.0, (2, 40))
    # float32: exp(-tau) of sums near 9 in another order, a few ulps each.
    for dt, rtol in ((np.float64, 1e-13), (np.float32, 1e-5)):
        a = [x.astype(dt) for x in (dtau, src, bg)]
        np.testing.assert_allclose(
            radiance_along_ray(*map(_t, a)).numpy(),
            np.asarray(jrt.radiance_along_ray(*map(jnp.asarray, a))),
            rtol=rtol)
        np.testing.assert_allclose(transmittance(_t(a[0])).numpy(),
                                   np.asarray(jrt.transmittance(
                                       jnp.asarray(a[0]))), rtol=rtol)
    seg = np.array([3, 2, 1, 0, 0, 1, 2, 3])
    lay_tau, lay_src = dtau[:, :4], src[:, :4]
    np.testing.assert_allclose(
        layer_path_radiance(_t(lay_tau), _t(lay_src), _t(seg), _t(bg)).numpy(),
        radiance_along_ray(_t(lay_tau[:, seg]), _t(lay_src[:, seg]),
                           _t(bg)).numpy(), rtol=1e-13)


def _nadir(atm, nu, T_s, eps):
    from spectrobot_tpu_torch.data.synth import co2_15um_band
    from spectrobot_tpu_torch.forward.geometry import nadir_path_cg
    from spectrobot_tpu_torch.forward.limb import nadir_radiance
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist
    dl = device_lines_from_linelist(co2_15um_band(j_max=8), [(2, 1)],
                                    dtype=torch.float64, device="cpu")
    cg = nadir_path_cg(atm, ["CO2"], torch.tensor([1.0], dtype=torch.float64),
                       n_sub=2)
    return nadir_radiance(_t(nu), dl, cg, T_s, emissivity=eps,
                          analytic_jvp=False, chunk=64).numpy()


def test_nadir_kirchhoff_isothermal():
    """An isothermal atmosphere over a surface at its temperature: the
    nadir radiance is B(T0) for any emissivity."""
    from spectrobot_tpu_torch.constants import K_BOLTZ
    from spectrobot_tpu_torch.data.atmosphere import Atmosphere
    T0, n_lev = 230.0, 7
    z = np.linspace(0, 50e3, n_lev)
    n = 2e23 * np.exp(-z / 11e3)
    atm = Atmosphere.from_numpy(z, n * K_BOLTZ * T0, np.full(n_lev, T0), n,
                                {"CO2": np.full(n_lev, 0.95)}, device="cpu")
    nu = np.linspace(660.0, 674.0, 200)
    B = numpy_ref.planck(nu, T0)
    for eps in (1.0, 0.7, 0.3):
        np.testing.assert_allclose(_nadir(atm, nu, T0, eps)[0], B,
                                   rtol=1e-8, err_msg=f"emissivity {eps}")


def test_reflection_darkens_cold_sky_windows():
    from spectrobot_tpu_torch.data.atmosphere import mars_standard_atmosphere
    atm = mars_standard_atmosphere(n_lev=7, z_top=60e3, device="cpu")
    nu = np.linspace(650.0, 674.0, 300)
    I_black = _nadir(atm, nu, 260.0, 1.0)
    I_grey = _nadir(atm, nu, 260.0, 0.6)
    window = nu < 656.0
    assert I_grey[0, window].mean() < 0.95 * I_black[0, window].mean()
