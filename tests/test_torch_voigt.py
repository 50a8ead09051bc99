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
