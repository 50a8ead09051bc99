"""Opacity line sum of the PyTorch port against the JAX reference: the host
window tables, the plain line sum (accumulate_jnp), and the batched kernel
wrapper on CPU tensors against the Pallas kernel K1 in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.synth import random_lines
from spectrobot_tpu.ops import pallas_opacity as jpo
from spectrobot_tpu.ops.opacity import accumulate_jnp
from spectrobot_tpu.ops.opacity import line_kernel_inputs as j_kernel_inputs
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu_torch.kernels import launch
from spectrobot_tpu_torch.ops import cuda_opacity as co
from spectrobot_tpu_torch.ops.opacity import KernelLines, accumulate_plain


@pytest.mark.parametrize("tile_p,block_l", [(128, 128), (256, 256),
                                            (256, 128)])
@pytest.mark.parametrize("cutoff", [25.0, 5.0, None])
def test_windows_match_reference(tile_p, block_l, cutoff):
    rng = np.random.default_rng(0)
    nu = np.linspace(-40.0, 40.0, 1500).astype(np.float32)
    nu0 = np.sort(rng.uniform(-70.0, 70.0, 700)).astype(np.float32)
    got = co.static_windows(nu, nu0, tile_p=tile_p, block_l=block_l,
                            cutoff_cm1=cutoff)
    ref = jpo.static_windows(nu, nu0, tile_p=tile_p, block_l=block_l,
                             cutoff_cm1=cutoff)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    # The unpadded block windows, as the reference tests them.
    nu_t = nu[:1280]
    nu0_b = nu0[:512]
    for g, r in zip(co._block_windows(nu_t, nu0_b, 128, 128, cutoff),
                    jpo._block_windows(nu_t, nu0_b, 128, 128, cutoff)):
        assert g.dtype == r.dtype == np.int32
        np.testing.assert_array_equal(g, r)


def _kernel_lines(n_lines=300, seed=0, dtype=jnp.float64):
    ll = random_lines(n_lines, 640.0, 700.0, seed=seed)
    dl = j_stage(ll, [(2, 1)], dtype=dtype, nu_ref=670.0)
    w = jnp.ones((2, dl.n_lines), dtype).at[1].mul(0.5)
    return dl, j_kernel_inputs(dl, 220.0, 300.0, 100.0, amp_weights=w)


@pytest.mark.parametrize("cutoff,with_chi", [(25.0, False), (None, False),
                                             (25.0, True)])
def test_accumulate_plain_f64(cutoff, with_chi):
    _, kl = _kernel_lines()
    if with_chi:
        chi = np.random.default_rng(1).uniform(0.0, 0.4, kl.nu_c.shape[0])
        kl = kl._replace(chi_b=jnp.asarray(chi))
    nu = np.linspace(-28.0, 28.0, 700)
    ref = np.asarray(accumulate_jnp(jnp.asarray(nu), kl, chunk=128,
                                    cutoff_cm1=cutoff))
    got = accumulate_plain(
        torch.as_tensor(nu),
        KernelLines(*(None if a is None else torch.tensor(np.asarray(a))
                      for a in kl)),
        chunk=100, cutoff_cm1=cutoff).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0)


def _batch_inputs(n_states=6, n_lines=60, n_points=500, seed=2):
    """States of one line list at spread (T, p), one of them all-zero, as
    float32 arrays: (nu, nu0, nu_c, sx, y, amps, chi_b)."""
    rng = np.random.default_rng(seed)
    dl, _ = _kernel_lines(n_lines, seed=seed, dtype=jnp.float32)
    T = rng.uniform(140.0, 250.0, n_states)
    p = 10.0 ** rng.uniform(-1.0, 4.5, n_states)
    nc, sx, y, amps = [], [], [], []
    for b in range(n_states):
        w = np.ones((2, n_lines)) * rng.uniform(0.1, 1.0, (2, 1)) * (b != 3)
        kl = j_kernel_inputs(dl, T[b], p[b], 0.9 * p[b], jnp.asarray(w))
        for acc, a in zip((nc, sx, y, amps), kl[:4]):
            acc.append(np.asarray(a, np.float32))
    nu = np.linspace(-25.0, 25.0, n_points).astype(np.float32)
    chi = rng.uniform(0.0, 0.4, (n_states, n_lines)).astype(np.float32)
    return (nu, np.asarray(dl.nu0, np.float32), np.stack(nc), np.stack(sx),
            np.stack(y), np.stack(amps), chi)


@pytest.mark.parametrize("with_chi", [False, True])
def test_accumulate_batch_cpu_matches_pallas_interpret(with_chi):
    nu, nu0, nc, sx, y, amps, chi = _batch_inputs()
    assert not amps[3].any() and amps[2].any()
    chi = chi if with_chi else None
    ref = np.asarray(jpo.accumulate_pallas_batch(
        jnp.asarray(nu), nu0, jnp.asarray(nc), jnp.asarray(sx),
        jnp.asarray(y), jnp.asarray(amps), cutoff_cm1=25.0, interpret=True,
        chi_b=None if chi is None else jnp.asarray(chi)))
    before = launch.LAUNCHES["opacity_batch_kernel"]
    t = torch.as_tensor
    got = co.accumulate_batch(
        t(nu), co.line_windows(t(nu), nu0), t(nc), t(sx), t(y), t(amps),
        cutoff_cm1=25.0,
        chi_b=None if chi is None else t(chi))
    # CPU tensors never launch.
    assert launch.LAUNCHES["opacity_batch_kernel"] == before
    assert got.dtype == torch.float32 and got.shape == ref.shape
    got = got.numpy()
    assert np.all(got[3] == 0.0)
    np.testing.assert_allclose(got, ref, rtol=3e-5,
                               atol=1e-6 * np.abs(ref).max())


def test_accumulate_batch_rejects_what_the_kernel_does_not_take():
    """Wrong shapes raise on any device; the kernel's own limits (float32,
    contiguous) are checked before a launch, while CPU tensors run the
    plain version in any dtype and layout."""
    nu, nu0, nc, sx, y, amps, _ = _batch_inputs(n_states=2, n_lines=8,
                                                n_points=16)
    t = torch.as_tensor
    args = [t(nu), co.line_windows(t(nu), nu0), t(nc), t(sx), t(y), t(amps)]
    with pytest.raises(ValueError, match="shape"):
        co.accumulate_batch(*args[:5], t(amps)[:, :1].contiguous())
    kernel_args = [args[0], *args[2:], None]
    with pytest.raises(TypeError, match="float32"):
        co._check(*kernel_args[:1], t(nc).double(), *kernel_args[2:],
                  kernel=True)
    with pytest.raises(ValueError, match="contiguous"):
        co._check(*kernel_args[:1], t(nc.T.copy()).T, *kernel_args[2:],
                  kernel=True)
    ref = co.accumulate_batch(*args)
    f64 = co.accumulate_batch(*[a.double() if isinstance(a, torch.Tensor)
                                else a for a in args])
    assert f64.dtype == torch.float64
    np.testing.assert_allclose(f64.numpy(), ref.numpy(), rtol=3e-5,
                               atol=1e-6 * float(ref.abs().max()))
    strided = co.accumulate_batch(*args[:2], t(nc.T.copy()).T, *args[3:])
    np.testing.assert_allclose(strided.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6 * float(ref.abs().max()))


def test_tier_counts_all_four_tiers_on_smoke_inputs():
    """The chip smoke's K1 cases, scaled down, exercise all four tiers."""
    import chip_smoke

    seen = {name: 0 for name in co.TIERS}
    for case in chip_smoke.k1_cases(torch.device("cpu"), n_points=2048,
                                    bench_rays=3):
        for name, n in co.tier_counts(
                case.windows, case.nu_c, case.sx, case.y, case.amps).items():
            seen[name] += n
    assert all(n > 0 for n in seen.values()), seen
