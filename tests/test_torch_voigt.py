"""Humlicek w4 of the PyTorch port against the JAX reference
(spectrobot_tpu.ops.voigt.wofz_humlicek4) on an (x, y) grid that covers all
four regions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.ops import voigt as jvoigt
from spectrobot_tpu_torch.ops import voigt as tvoigt


def _grid():
    # |x| from the line core to the far wing, y from Doppler- to
    # pressure-dominated; every region of w4 is populated.
    x = np.concatenate([-np.logspace(-3, 4, 60)[::-1], [0.0],
                        np.logspace(-3, 4, 60)])
    y = np.concatenate([[1e-4, 1e-3, 0.01, 0.05, 0.1, 0.3, 0.6, 0.9, 1.2,
                         2.0, 4.0, 8.0, 20.0]])
    X, Y = np.meshgrid(x, y)
    return X.ravel(), Y.ravel()


def _regions(x, y):
    s = np.abs(x) + y
    r4 = (s < 5.5) & (y < 0.195 * np.abs(x) - 0.176)
    return {1: s >= 15, 2: (s >= 5.5) & (s < 15), 3: (s < 5.5) & ~r4, 4: r4}


def test_grid_covers_all_regions():
    x, y = _grid()
    for k, m in _regions(x, y).items():
        assert m.sum() > 20, k


@pytest.mark.parametrize("with_region4", [True, False])
def test_humlicek4_f64(with_region4):
    x, y = _grid()
    if not with_region4:        # the caller's guarantee: no region-IV pair
        keep = ~_regions(x, y)[4]
        x, y = x[keep], y[keep]
    ref = jvoigt.wofz_humlicek4(jnp.asarray(x), jnp.asarray(y),
                                with_region4=with_region4)
    got = tvoigt.wofz_humlicek4(torch.as_tensor(x), torch.as_tensor(y),
                                with_region4=with_region4)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-300)


@pytest.mark.parametrize("with_region4", [True, False])
def test_humlicek4_f32(with_region4):
    x, y = _grid()
    if not with_region4:
        keep = ~_regions(x, y)[4]
        x, y = x[keep], y[keep]
    x32, y32 = x.astype(np.float32), y.astype(np.float32)
    ref, _ = jvoigt.wofz_humlicek4(jnp.asarray(x32), jnp.asarray(y32),
                                   with_region4=with_region4)
    got, _ = tvoigt.wofz_humlicek4(torch.as_tensor(x32),
                                   torch.as_tensor(y32),
                                   with_region4=with_region4)
    ref = np.asarray(ref)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    m = ref > 1e-12
    np.testing.assert_allclose(got.numpy()[m], ref[m], rtol=1e-5)


@pytest.mark.parametrize("with_region4", [True, False])
def test_humlicek4_grad_f64(with_region4):
    """The closed-form w4 derivative against the reference's, float64, in
    each region's own sample set."""
    x, y = _grid()
    regions = _regions(x, y)
    if not with_region4:
        keep = ~regions[4]
        x, y = x[keep], y[keep]
        regions = _regions(x, y)
    ref = [np.asarray(r) for r in jvoigt.wofz_humlicek4_grad(
        jnp.asarray(x), jnp.asarray(y), with_region4=with_region4)]
    got = [g.numpy() for g in tvoigt.wofz_humlicek4_grad(
        torch.as_tensor(x), torch.as_tensor(y), with_region4=with_region4)]
    for k, m in regions.items():
        if not m.any():
            continue
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g[m], r[m], rtol=1e-12,
                                       atol=1e-300, err_msg=f"region {k}")


def test_humlicek4_grad_f32():
    """float32 partials within 1e-5 of the largest reference value of each
    region's sample set (the derivative spans many decades there)."""
    x, y = _grid()
    x32, y32 = x.astype(np.float32), y.astype(np.float32)
    ref = [np.asarray(r) for r in jvoigt.wofz_humlicek4_grad(
        jnp.asarray(x32), jnp.asarray(y32))]
    got = tvoigt.wofz_humlicek4_grad(torch.as_tensor(x32),
                                     torch.as_tensor(y32))
    assert all(g.dtype == torch.float32 for g in got)
    for k, m in _regions(x, y).items():
        for r, g in zip(ref, got):
            scale = np.abs(r[m]).max()
            assert np.max(np.abs(g.numpy()[m] - r[m])) <= 1e-5 * scale, k


def test_humlicek4_grad_primal_is_w4():
    """The gradient's (wr, wi) are the primal evaluator's values."""
    x, y = _grid()
    w = tvoigt.wofz_humlicek4(torch.as_tensor(x), torch.as_tensor(y))
    g = tvoigt.wofz_humlicek4_grad(torch.as_tensor(x), torch.as_tensor(y))
    for a, b in zip(w, g[:2]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-14,
                                   atol=1e-300)


# ---------------------------------------------------------------------------
# The Weideman evaluator and the Voigt profile: tests/test_voigt.py's seven
# checks on the port, and the port against the reference
# ---------------------------------------------------------------------------

from scipy.special import wofz as scipy_wofz  # noqa: E402


def _xy_plane():
    """tests/test_voigt.py's (x, y) plane."""
    x = np.concatenate([np.linspace(0.0, 40.0, 241),
                        10.0 ** np.linspace(-3, 1.5, 60)])
    y = 10.0 ** np.linspace(-6, 3, 80)
    return np.meshgrid(x, y)


def _t(a):
    return torch.as_tensor(a)


def test_weideman_coeffs_equal_the_reference():
    for n in (16, 32):
        assert tvoigt.weideman_coeffs(n) == jvoigt.weideman_coeffs(n)


def test_weideman_matches_wofz_f64():
    X, Y = _xy_plane()
    ref = scipy_wofz(X + 1j * Y)
    wr, wi = tvoigt.wofz_weideman(_t(X), _t(Y))
    np.testing.assert_allclose(wr.numpy(), ref.real, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(wi.numpy(), ref.imag, rtol=1e-6, atol=1e-12)


def test_humlicek4_region_boundaries():
    X, Y = _xy_plane()
    ref = scipy_wofz(X + 1j * Y).real
    wr, _ = tvoigt.wofz_humlicek4(_t(X), _t(Y))
    rel = np.abs(wr.numpy() - ref) / np.maximum(np.abs(ref), 1e-300)
    assert rel.max() < 1e-3, rel.max()


def test_humlicek4_f32_wing_accuracy():
    X, Y = _xy_plane()
    ref = scipy_wofz(X + 1j * Y).real
    wr, _ = tvoigt.wofz_humlicek4(_t(np.float32(X)), _t(np.float32(Y)))
    rel = np.abs(wr.numpy().astype(np.float64) - ref) / np.maximum(ref,
                                                                   1e-300)
    assert rel[ref > 1e-12].max() < 5e-4


def test_weideman_grad_matches_ad_f64():
    """The closed-form derivative equals autograd through the same
    approximant (it is its derivative) to machine precision."""
    X, Y = _xy_plane()
    x, y = _t(X).requires_grad_(), _t(Y).requires_grad_()
    wr, wi, kx, ky = tvoigt.wofz_weideman_grad(x.detach(), y.detach())
    ref_wr, ref_wi = tvoigt.wofz_weideman(x, y)
    np.testing.assert_allclose(wr.numpy(), ref_wr.detach().numpy(),
                               rtol=1e-13)
    np.testing.assert_allclose(wi.numpy(), ref_wi.detach().numpy(),
                               rtol=1e-13)
    ad_kx, ad_ky = torch.autograd.grad(ref_wr.sum(), (x, y))
    sx, sy = float(ad_kx.abs().max()), float(ad_ky.abs().max())
    np.testing.assert_allclose(kx.numpy(), ad_kx.numpy(), rtol=1e-10,
                               atol=sx * 1e-13)
    np.testing.assert_allclose(ky.numpy(), ad_ky.numpy(), rtol=1e-10,
                               atol=sy * 1e-13)


def test_weideman_grad_f32_wing_stability():
    """Per-pair relative accuracy of the float32 partials in deep wings,
    where the identity w' = -2 z w + 2i/sqrt(pi) is noise (the reference's
    bounds)."""
    x = 10.0 ** np.linspace(0.0, 4.5, 120)
    y = 10.0 ** np.linspace(-4, 1, 40)
    X, Y = np.meshgrid(x, y)
    _, _, kx64, ky64 = (a.numpy() for a in tvoigt.wofz_weideman_grad(
        _t(X), _t(Y)))
    _, _, kx32, ky32 = (a.numpy().astype(np.float64) for a in
                        tvoigt.wofz_weideman_grad(_t(np.float32(X)),
                                                  _t(np.float32(Y))))
    relx = np.abs(kx32 - kx64) / np.maximum(np.abs(kx64), 1e-300)
    rely = np.abs(ky32 - ky64) / np.maximum(np.abs(ky64), 1e-300)
    assert relx[np.abs(kx64) > 1e-8].max() < 2e-2
    assert rely[np.abs(ky64) > 1e-8].max() < 5e-4
    assert (np.abs(kx32 - kx64) * np.maximum(X, 1.0) ** 2).max() < 1e-4
    wr32, wi32 = (a.numpy() for a in tvoigt.wofz_weideman(
        _t(np.float32(X)), _t(np.float32(Y))))
    id_kx32 = -2.0 * (np.float32(X) * wr32 - np.float32(Y) * wi32)
    rel_id = np.abs(id_kx32.astype(np.float64) - kx64) / np.maximum(
        np.abs(kx64), 1e-300)
    deep = (X > 3e3) & (np.abs(kx64) > 1e-14)
    assert rel_id[deep].max() > 1.0


@pytest.mark.parametrize("variant", ["weideman", "humlicek4"])
def test_voigt_profile_normalisation(variant):
    nu = np.linspace(-400.0, 400.0, 200001)
    v = tvoigt.voigt_profile(_t(nu), 0.01, 0.5, variant=variant).numpy()
    assert abs(np.trapezoid(v, nu) - 1.0) < 2e-3


def test_voigt_profile_limits():
    """Pure-Doppler limit -> Gaussian; pressure-dominated -> Lorentzian."""
    nu = np.linspace(-1.0, 1.0, 2001)
    ad, gl_tiny = 0.05, 1e-9
    v = tvoigt.voigt_profile(_t(nu), ad, gl_tiny).numpy()
    gauss = np.sqrt(np.log(2) / np.pi) / ad * np.exp(-np.log(2)
                                                     * (nu / ad) ** 2)
    tail = gl_tiny / np.pi / np.maximum(nu ** 2, ad ** 2)
    np.testing.assert_allclose(v, gauss, rtol=1e-5,
                               atol=float(tail.max()) * 1.5)
    gl = 0.3
    v = tvoigt.voigt_profile(_t(nu), 1e-5, gl).numpy()
    np.testing.assert_allclose(v, gl / np.pi / (nu ** 2 + gl ** 2),
                               rtol=1e-4)
    with pytest.raises(ValueError, match="unknown voigt variant"):
        tvoigt.voigt_profile(_t(nu), ad, gl, variant="humlicek")


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-6)])
def test_weideman_matches_jax(dtype, rtol):
    """wofz_weideman and wofz_weideman_grad against the reference's on
    _grid() (every Humlicek region, core to x = 1e4), each output within
    rtol of its own largest magnitude there."""
    x, y = (a.astype(dtype) for a in _grid())
    pairs = ((jvoigt.wofz_weideman, tvoigt.wofz_weideman),
             (jvoigt.wofz_weideman_grad, tvoigt.wofz_weideman_grad))
    for jf, tf in pairs:
        ref = [np.asarray(r) for r in jf(jnp.asarray(x), jnp.asarray(y))]
        got = [g.numpy() for g in tf(_t(x), _t(y))]
        for r, g in zip(ref, got):
            assert g.dtype == r.dtype == dtype
            np.testing.assert_allclose(g, r, rtol=rtol,
                                       atol=rtol * np.abs(r).max())


@pytest.mark.parametrize("variant", ["weideman", "humlicek4"])
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-6)])
def test_voigt_profile_matches_jax(variant, dtype, rtol):
    rng = np.random.default_rng(3)
    dnu = rng.uniform(-30.0, 30.0, 4000).astype(dtype)
    ad = rng.uniform(5e-4, 2e-3, 4000).astype(dtype)
    gl = rng.uniform(1e-5, 0.1, 4000).astype(dtype)
    ref = np.asarray(jvoigt.voigt_profile(jnp.asarray(dnu), jnp.asarray(ad),
                                          jnp.asarray(gl), variant=variant))
    got = tvoigt.voigt_profile(_t(dnu), _t(ad), _t(gl), variant=variant)
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())
