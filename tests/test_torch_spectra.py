"""The Spectrum family of the PyTorch port (spectrobot_tpu_torch/spectra.py)
against the JAX reference: tests/test_spectra.py's checks on the port, each
operation against the reference's on the same numpy inputs, files written
by either package read by the other, and the linear regrid at and beyond
both edges of the grid."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu import spectra as jsp
from spectrobot_tpu.ops import planck as jplanck
from spectrobot_tpu_torch import spectra as tsp
from spectrobot_tpu_torch.ops.planck import (
    brightness_temperature, nlte_line_weights, planck_nu,
    vib_population_ratio)

torch.set_num_threads(1)


def _grid(P=128):
    return np.linspace(600.0, 700.0, P)


def test_arithmetic_and_kinds():
    nu = _grid()
    a = tsp.radiance(nu, torch.ones((3, nu.shape[0]),
                                    dtype=torch.float64) * 2.0)
    b = tsp.radiance(nu, torch.ones((3, nu.shape[0]), dtype=torch.float64))
    c = a + b
    assert c.kind == "radiance"
    np.testing.assert_allclose(c.values.numpy(), 3.0)
    d = a * 0.5 - 1.0
    np.testing.assert_allclose(d.values.numpy(), 0.0)
    np.testing.assert_allclose((1.0 - a).values.numpy(), -1.0)
    np.testing.assert_allclose((a / b).values.numpy(), 2.0)
    np.testing.assert_allclose((-a).values.numpy(), -2.0)
    assert (a ** 2).kind == "generic"
    assert (2.0 * a).kind == "radiance"
    e = a + tsp.optical_depth(nu, torch.ones((3, nu.shape[0])))
    assert e.kind == "generic"
    with pytest.raises(ValueError, match="grids differ"):
        a + tsp.radiance(_grid(64), torch.ones((3, 64)))
    with pytest.raises(ValueError, match="unknown spectrum kind"):
        tsp.Spectrum(nu, b.values, "intensity")


def test_conversions_roundtrip():
    nu = _grid()
    tau = tsp.optical_depth(nu, torch.linspace(0.0, 5.0, nu.shape[0],
                                               dtype=torch.float64))
    t = tau.to_transmittance()
    assert t.kind == "transmittance"
    assert float(t.values.min()) > 0.0 and float(t.values.max()) <= 1.0
    back = t.to_optical_depth()
    np.testing.assert_allclose(back.values.numpy(), tau.values.numpy(),
                               rtol=1e-12)
    with pytest.raises(ValueError):
        t.to_transmittance()
    # A zero transmittance clips at the dtype's tiny, as the reference.
    for dt, tiny in ((torch.float64, 1e-300), (torch.float32, 1e-38)):
        z = tsp.transmittance(nu[:2], torch.zeros(2, dtype=dt))
        np.testing.assert_allclose(z.to_optical_depth().values.numpy(),
                                   -np.log(tiny), rtol=1e-6)


def test_brightness_temperature_inverts_planck():
    nu = _grid()
    T = 215.0
    I = tsp.radiance(nu, planck_nu(torch.as_tensor(nu), T))
    tb = I.brightness_temperature()
    assert tb.kind == "brightness_temperature"
    np.testing.assert_allclose(tb.values.numpy(), T, rtol=1e-10)
    z = tsp.radiance(nu, torch.zeros(nu.shape[0], dtype=torch.float64))
    assert np.all(z.brightness_temperature().values.numpy() == 0.0)


def test_integrate_matches_numpy_trapezoid():
    nu = _grid()
    v = np.sin(nu / 30.0) ** 2
    s = tsp.Spectrum(nu, torch.as_tensor(v))
    np.testing.assert_allclose(float(s.integrate()), np.trapezoid(v, nu),
                               rtol=1e-12)
    np.testing.assert_allclose(float(s.mean()), v.mean(), rtol=1e-12)


def test_interp_and_slice():
    nu = _grid(256)
    s = tsp.radiance(nu, torch.as_tensor(np.stack([nu * 0 + 1.0, nu])))
    nu2 = np.linspace(610.0, 690.0, 57)
    r = s.interp_to(nu2)
    assert r.kind == "radiance" and r.values.shape == (2, 57)
    np.testing.assert_allclose(r.values[1].numpy(), nu2, rtol=1e-12)
    sl = s[10:20]
    assert sl.n_points == 10 and sl.values.shape == (2, 10)
    np.testing.assert_array_equal(sl.nu, nu[10:20])


def test_convolve_ils_flat_preserved():
    nu = _grid(512)
    s = tsp.radiance(nu, torch.full((4, 512), 2.5, dtype=torch.float64))
    out = s.convolve_ils(np.linspace(620.0, 680.0, 31), fwhm=1.0)
    assert out.values.shape == (4, 31)
    np.testing.assert_allclose(out.values.numpy(), 2.5, rtol=1e-6)


def test_autograd_through_the_object_api():
    """The reference's jit/grad composition, in torch: a band transmittance
    differentiates through the Spectrum methods."""
    nu = _grid()
    tau0 = torch.linspace(0.1, 2.0, nu.shape[0],
                          dtype=torch.float64).requires_grad_()
    band = tsp.optical_depth(nu, tau0).to_transmittance().integrate()
    assert np.isfinite(float(band.detach()))
    (g,) = torch.autograd.grad(band, tau0)
    assert g.shape == tau0.shape and bool(torch.all(g < 0.0))


def _pair(kind, values, nu):
    return (jsp.Spectrum(jnp.asarray(nu), jnp.asarray(values), kind),
            tsp.Spectrum(nu, torch.as_tensor(values), kind))


def _same(got, ref, rtol=1e-13):
    if isinstance(ref, jsp.Spectrum):
        assert got.kind == ref.kind and got.units == ref.units
        np.testing.assert_allclose(got.nu, np.asarray(ref.nu), rtol=0)
        ref, got = ref.values, got.values
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(ref)).max())


def test_operations_match_jax():
    """Every operation of the two packages on the same seeded spectra."""
    rng = np.random.default_rng(7)
    nu = np.linspace(640.0, 700.0, 200)
    I = planck_nu(torch.as_tensor(nu), 220.0).numpy() * rng.uniform(
        0.5, 1.0, (3, 200))
    tau = rng.uniform(0.0, 4.0, (3, 200))
    jr, tr = _pair("radiance", I, nu)
    jt, tt = _pair("optical_depth", tau, nu)
    _same(tr + tr * 0.5, jr + jr * 0.5)
    _same(2.0 - tr / 3.0, 2.0 - jr / 3.0)
    _same(tr + tt, jr + jt)
    _same(tr ** 2, jr ** 2)
    _same(tt.to_transmittance(), jt.to_transmittance())
    _same(tt.to_transmittance().to_optical_depth(),
          jt.to_transmittance().to_optical_depth(), rtol=1e-12)
    _same(tr.brightness_temperature(), jr.brightness_temperature())
    _same(tr.integrate(), jr.integrate())
    _same(tr.mean(), jr.mean())
    _same(tr[20:120], jr[20:120])
    chans = np.linspace(650.0, 690.0, 17)
    _same(tr.convolve_ils(chans, 1.5), jr.convolve_ils(chans, 1.5))
    _same(tr.convolve_ils(chans, 1.5, shape="sinc", cutoff_fwhm=4.0),
          jr.convolve_ils(chans, 1.5, shape="sinc", cutoff_fwhm=4.0))
    for kind in tsp.KINDS:
        assert tsp.UNITS[kind] == jsp.UNITS[kind]
    assert tsp.KINDS == jsp.KINDS
    for name in ("radiance", "optical_depth", "transmittance",
                 "absorption_coeff", "emission_coeff"):
        assert getattr(tsp, name)(nu, tau).kind == getattr(jsp, name)(
            nu, tau).kind == name


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_interp_to_at_and_beyond_both_edges(dtype):
    """The linear regrid against jnp.interp's: points on the grid's nodes,
    between them, exactly at both ends, beyond both ends (flat) and a
    repeated node."""
    rng = np.random.default_rng(9)
    nu = np.sort(rng.uniform(600.0, 700.0, 64))
    nu[10] = nu[11]                       # a repeated node
    v = rng.standard_normal((2, 64)).astype(dtype)
    nu_new = np.concatenate([[500.0, nu[0] - 1e-9, nu[0]], nu[5:9],
                             np.linspace(nu[0], nu[-1], 41), [nu[10]],
                             [nu[-1], nu[-1] + 1e-9, 800.0]])
    jr, tr = _pair("radiance", v, nu)
    ref = jr.interp_to(jnp.asarray(nu_new))
    got = tr.interp_to(nu_new)
    assert got.values.dtype == tr.values.dtype
    _same(got.values, np.asarray(ref.values, dtype),
          rtol=1e-12 if dtype == np.float64 else 1e-6)
    np.testing.assert_array_equal(got.values[:, 0].numpy(), v[:, 0])
    np.testing.assert_array_equal(got.values[:, -1].numpy(), v[:, -1])
    np.testing.assert_array_equal(got.values[:, 1].numpy(), v[:, 0])
    np.testing.assert_array_equal(got.values[:, -2].numpy(), v[:, -1])
    np.testing.assert_allclose(got.nu, nu_new)


def test_npz_files_cross_both_ways(tmp_path):
    """save_npz keeps the reference's keys: each package loads the other's
    file, extra arrays included."""
    rng = np.random.default_rng(11)
    nu = np.linspace(650.0, 690.0, 50)
    v = rng.uniform(0.0, 1.0, (2, 50))
    jt, tt = _pair("transmittance", v, nu)
    extra = {"tangent_heights_km": np.array([10.0, 20.0])}
    tt.save_npz(str(tmp_path / "t.npz"), **extra)
    jt.save_npz(str(tmp_path / "j.npz"), **extra)
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    from_port = jsp.Spectrum.load_npz(str(tmp_path / "t.npz"))
    from_ref = tsp.Spectrum.load_npz(str(tmp_path / "j.npz"))
    _same(from_ref, from_port, rtol=0)
    assert from_ref.values.dtype == torch.float64
    assert repr(from_ref) == repr(from_port)


def test_planck_helpers_match_jax():
    """brightness_temperature (with its dtype's guard), nlte_line_weights
    and vib_population_ratio against the reference's."""
    rng = np.random.default_rng(13)
    nu = np.linspace(600.0, 2400.0, 64)
    I = np.concatenate([planck_nu(torch.as_tensor(nu[:60]), 200.0).numpy(),
                        [0.0, -1.0, 1e-200, 1e-30]])
    for dt in (np.float64, np.float32):
        ref = jplanck.brightness_temperature(jnp.asarray(nu, dt),
                                             jnp.asarray(I, dt))
        got = brightness_temperature(torch.as_tensor(nu.astype(dt)),
                                     torch.as_tensor(I.astype(dt)))
        assert got.numpy().dtype == dt
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-12 if dt == np.float64 else 1e-6)
    nu0 = rng.uniform(600.0, 2400.0, 20)
    r_l, r_u = rng.uniform(0.5, 2.0, 20), rng.uniform(0.5, 2.0, 20)
    for g, r in zip(nlte_line_weights(*map(torch.as_tensor,
                                           (nu0, 180.0, r_l, r_u))),
                    jplanck.nlte_line_weights(*map(jnp.asarray,
                                                   (nu0, 180.0, r_l, r_u)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13)
    e = rng.uniform(500.0, 3000.0, 20)
    np.testing.assert_allclose(
        vib_population_ratio(torch.as_tensor(e), 230.0, 180.0).numpy(),
        np.asarray(jplanck.vib_population_ratio(jnp.asarray(e), 230.0,
                                                180.0)), rtol=1e-13)


def test_forward_model_returns_wrap():
    """The library API composes: a limb radiance of the port's forward
    wrapped as a Spectrum, its brightness temperature and channels."""
    from spectrobot_tpu_torch.data.atmosphere import (
        MARS, mars_standard_atmosphere)
    from spectrobot_tpu_torch.data.synth import co2_15um_band
    from spectrobot_tpu_torch.forward.geometry import limb_path_cg
    from spectrobot_tpu_torch.forward.limb import limb_radiance
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist

    atm = mars_standard_atmosphere(n_lev=8, z_top=60e3, device="cpu")
    dl = device_lines_from_linelist(co2_15um_band(j_max=6), [(2, 1)],
                                    dtype=torch.float64, device="cpu",
                                    nu_ref=0.0)
    nu = np.linspace(664.0, 670.0, 128)
    cg = limb_path_cg(atm, ["CO2"], torch.tensor([15e3, 30e3],
                                                 dtype=torch.float64),
                      MARS, 2)
    I = tsp.radiance(nu, limb_radiance(torch.as_tensor(nu), dl, cg))
    tb = I.brightness_temperature()
    assert float(tb.values.max()) < float(atm.T.max()) + 1.0
    chan = I.convolve_ils(np.linspace(665.0, 669.0, 9), fwhm=0.3)
    assert chan.values.shape == (2, 9)
    assert bool(torch.isfinite(chan.values).all())
