"""``cross_sections``, ``cross_sections_batch`` and acceptance config 1
(``forward.model.nadir_single_layer``) of the PyTorch port against the JAX
reference and the independent float64 NumPy oracle (tests/golden), on the
CPU, where the single-state op runs the plain versions of K3, K4 and K5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import numpy_ref
from spectrobot_tpu.data import tips
from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.forward.model import nadir_single_layer as j_nadir
from spectrobot_tpu.ops import opacity as jop
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu_torch import interop
from spectrobot_tpu_torch.forward.model import nadir_single_layer
from spectrobot_tpu_torch.ops import opacity as top

# These tests run tiny tensors: torch's intra-op threads would only
# contend (and spin-wait) with the other test workers for the cores.
torch.set_num_threads(1)

SPECIES = [(2, 1)]


def _lines(j_max, dtype):
    """The reference's CO2 band staged by the reference, and the same lines
    in the port."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ll = co2_15um_band(j_max=j_max)
    dl = j_stage(ll, SPECIES, dtype=jdt)
    tl = interop.device_lines_from_numpy(
        {k: np.asarray(v) for k, v in dl._asdict().items()},
        device=torch.device("cpu"))
    return ll, dl, tl


def _setup(j_max=25, dtype=torch.float64):
    """tests/test_opacity.py's scene: 640-700 cm-1 on 4001 points, T 220 K,
    p 400 Pa."""
    ll, dl, tl = _lines(j_max, dtype)
    nu = np.linspace(640.0, 700.0, 4001)
    T, p = 220.0, 400.0
    q_ratio = np.full(len(ll), tips.q_of_T(2, 1, 296.0) / tips.q_of_T(2, 1, T))
    return ll, dl, tl, nu, T, p, q_ratio


@pytest.mark.parametrize("analytic_jvp", [True, "rev", False])
def test_cross_sections_match_jax_and_oracle(analytic_jvp):
    """float64: within 1e-10 of max|ref| of the reference (engine 'jnp')
    on every route, and the oracle's humlicek4 budget
    (tests/test_opacity.py: rtol 2e-3, atol 1e-7 max)."""
    ll, dl, tl, nu, T, p, q_ratio = _setup()
    ref = jop.cross_sections(jnp.asarray(nu), dl, T, p, 0.3 * p,
                             cutoff_cm1=25.0)
    got = top.cross_sections(torch.as_tensor(nu), tl, T, p, 0.3 * p,
                             cutoff_cm1=25.0, analytic_jvp=analytic_jvp)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-10 * np.abs(r).max())
    oa, oe = numpy_ref.cross_section(nu, ll, T, p, 0.3 * p, q_ratio,
                                     cutoff=25.0)
    for o, g in ((oa, got[0]), (oe, got[1])):
        np.testing.assert_allclose(g.numpy(), o, rtol=2e-3,
                                   atol=o.max() * 1e-7)


def test_cross_sections_float32_match_jax():
    """float32 against the reference's float32 cross sections within the
    Pallas parity budget (3e-5 |ref| + 1e-6 max|ref|)."""
    _, dl, tl, nu, T, p, _ = _setup(j_max=12, dtype=torch.float32)
    ref = jop.cross_sections(jnp.asarray(nu, jnp.float32), dl, T, p, 0.3 * p)
    got = top.cross_sections(torch.as_tensor(nu, dtype=torch.float32), tl, T,
                             p, 0.3 * p)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, rtol=3e-5,
                                   atol=1e-6 * np.abs(r).max())


def test_chunk_invariance():
    _, _, tl, nu, T, p, _ = _setup(j_max=17)  # an awkward line count
    nu = torch.as_tensor(nu)
    a1, _ = top.cross_sections(nu, tl, T, p, chunk=7, analytic_jvp=False)
    a2, _ = top.cross_sections(nu, tl, T, p, chunk=256, analytic_jvp=False)
    a3, _ = top.cross_sections(nu, tl, T, p)
    np.testing.assert_allclose(a1.numpy(), a2.numpy(), rtol=1e-12)
    np.testing.assert_allclose(a3.numpy(), a2.numpy(), rtol=1e-12)


def test_nlte_weights_enter_linearly():
    _, dl, tl, nu, T, p, _ = _setup(j_max=10)
    L = tl.n_lines
    wa = np.random.default_rng(0).uniform(0.5, 1.5, L)
    we = np.random.default_rng(1).uniform(0.5, 1.5, L)
    t = torch.as_tensor
    a, e = top.cross_sections(t(nu), tl, T, p, w_abs=t(wa), w_em=t(we))
    a1, e1 = top.cross_sections(t(nu), tl, T, p, w_abs=t(2.0 * wa),
                                w_em=t(3.0 * we))
    np.testing.assert_allclose(a1.numpy(), 2 * a.numpy(), rtol=1e-10)
    np.testing.assert_allclose(e1.numpy(), 3 * e.numpy(), rtol=1e-10)
    ra, re = jop.cross_sections(jnp.asarray(nu), dl, T, p,
                                w_abs=jnp.asarray(wa), w_em=jnp.asarray(we))
    for r, g in ((ra, a), (re, e)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-10 * np.abs(np.asarray(r)).max())


def test_layer_batching_matches_loop_and_jax():
    """``cross_sections_batch`` (a vmap: the batched op) against the
    per-layer calls and the reference's batch, float64; and its jacfwd over
    the layer temperatures against the reference's."""
    _, dl, tl, nu, _, _, _ = _setup(j_max=12)
    T_lay = np.array([180.0, 220.0, 260.0])
    p_lay = np.array([600.0, 60.0, 6.0])
    t = torch.as_tensor
    ba, be = top.cross_sections_batch(t(nu), tl, t(T_lay), t(p_lay),
                                      t(0.9 * p_lay))
    for i in range(3):
        a, e = top.cross_sections(t(nu), tl, T_lay[i], p_lay[i],
                                  0.9 * p_lay[i])
        np.testing.assert_allclose(ba[i].numpy(), a.numpy(), rtol=1e-12)
        np.testing.assert_allclose(be[i].numpy(), e.numpy(), rtol=1e-12)
    ra, _ = jop.cross_sections_batch(jnp.asarray(nu), dl, jnp.asarray(T_lay),
                                     jnp.asarray(p_lay),
                                     jnp.asarray(0.9 * p_lay))
    ra = np.asarray(ra)
    np.testing.assert_allclose(ba.numpy(), ra, rtol=0,
                               atol=1e-10 * np.abs(ra).max())
    J_ref = np.asarray(jax.jacfwd(lambda T: jop.cross_sections_batch(
        jnp.asarray(nu), dl, T, jnp.asarray(p_lay),
        jnp.asarray(0.9 * p_lay))[0])(jnp.asarray(T_lay)))
    J = torch.func.jacfwd(lambda T: top.cross_sections_batch(
        t(nu), tl, T, t(p_lay), t(0.9 * p_lay))[0])(t(T_lay)).numpy()
    assert J.shape == J_ref.shape == (3, 4001, 3)
    assert np.max(np.abs(J - J_ref)) <= 1e-8 * np.abs(J_ref).max()


@pytest.mark.parametrize("analytic_jvp", ["rev", False])
def test_grad_matches_finite_difference(analytic_jvp):
    """d sum(sigma_abs) / dT by reverse mode against central differences
    and the reference's plain-AD gradient (tests/test_opacity.py)."""
    _, dl, tl, nu, _, _, _ = _setup(j_max=8)
    nu = nu[:501]
    total = lambda T: top.cross_sections(
        torch.as_tensor(nu), tl, T, 300.0, analytic_jvp=analytic_jvp)[0].sum()
    # Inside a partition-sum table interval (piecewise linear in T).
    T0 = torch.tensor(221.3, dtype=torch.float64, requires_grad=True)
    g = torch.autograd.grad(total(T0), T0)[0].item()
    eps = 1e-3
    with torch.no_grad():
        fd = (total(T0 + eps) - total(T0 - eps)).item() / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-5)
    ref = jax.grad(lambda T: jnp.sum(jop.cross_sections(
        jnp.asarray(nu), dl, T, 300.0, analytic_jvp=False)[0]))(221.3)
    np.testing.assert_allclose(g, float(ref), rtol=1e-10)


# ---------------------------------------------------------------------------
# Acceptance config 1 (BASELINE.json:7, tests/test_config1_golden.py)
# ---------------------------------------------------------------------------

CONFIG1 = dict(T_layer=215.0, p_layer_pa=500.0, column_m2=2.0e27,
               vmr_self=0.95, T_surface=260.0)


def _config1(dtype):
    ll, dl, tl = _lines(30, dtype)
    return ll, dl, tl, np.linspace(630.0, 705.0, 3001)


def _oracle(ll, nu, sc):
    T = sc["T_layer"]
    q_ratio = np.full(len(ll), tips.q_of_T(2, 1, 296.0) / tips.q_of_T(2, 1, T))
    return numpy_ref.nadir_single_layer(
        nu, ll, T, sc["p_layer_pa"], sc["column_m2"], sc["vmr_self"],
        sc["T_surface"], q_ratio, cutoff=25.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_config1_matches_jax_and_oracle(dtype):
    """Config 1's radiance: the oracle's float32 hot-path budget (rtol
    5e-3, atol 1e-4 max; tests/test_config1_golden.py:57) in both dtypes,
    and the reference's humlicek4 radiance within 1e-10 (float64) or the
    Pallas parity budget (float32)."""
    ll, dl, tl, nu = _config1(dtype)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    got = nadir_single_layer(torch.as_tensor(nu, dtype=dtype), tl,
                             **CONFIG1).numpy()
    assert got.dtype == (np.float64 if dtype == torch.float64
                         else np.float32)
    golden = _oracle(ll, nu, CONFIG1)
    np.testing.assert_allclose(got.astype(np.float64), golden, rtol=5e-3,
                               atol=golden.max() * 1e-4)
    ref = np.asarray(j_nadir(jnp.asarray(nu, jdt), dl, **CONFIG1))
    if dtype == torch.float64:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=3e-5,
                                   atol=1e-6 * np.abs(ref).max())


def _config1_fns(sc):
    """Config 1's radiance as a function of its five scalars, in both
    packages (float64)."""
    ll, dl, tl, nu = _config1(torch.float64)
    keys = list(sc)

    def t(mode):
        return lambda *x: nadir_single_layer(
            torch.as_tensor(nu), tl, **dict(zip(keys, x)),
            analytic_jvp=mode)
    j = lambda *x: j_nadir(jnp.asarray(nu), dl, **dict(zip(keys, x)))
    return t, j, [sc[k] for k in keys]


def test_config1_jacobian_matches_jax():
    """jacfwd over (T_layer, p, column, vmr_self, T_surface) against
    jax.jacfwd within 1e-8 of max|J| per column, in forward and reverse
    mode."""
    t, j, x0 = _config1_fns(CONFIG1)
    argn = tuple(range(5))
    J_ref = [np.asarray(c) for c in jax.jacfwd(j, argnums=argn)(*x0)]
    x = [torch.tensor(v, dtype=torch.float64) for v in x0]
    for mode, jac in ((True, torch.func.jacfwd), ("rev", torch.func.jacrev)):
        J = jac(t(mode), argnums=argn)(*x)
        for r, g in zip(J_ref, J):
            assert np.max(np.abs(g.numpy() - r)) <= 1e-8 * np.abs(r).max()


def test_config1_jacobian_matches_finite_difference():
    """The analytic config-1 Jacobian against central differences, float64,
    at config 1's state with T_layer moved to 217.5 K, mid-interval of the
    partition-sum table (215 K is a node of the piecewise-linear table,
    where the one-sided slopes differ)."""
    sc = dict(CONFIG1, T_layer=217.5)
    t, _, x0 = _config1_fns(sc)
    f = t(True)
    x = [torch.tensor(v, dtype=torch.float64) for v in x0]
    J = torch.func.jacfwd(f, argnums=tuple(range(5)))(*x)
    for k in range(5):
        h = 1e-6 * max(abs(x0[k]), 1.0)
        xp = list(x)
        xm = list(x)
        xp[k] = x[k] + h
        xm[k] = x[k] - h
        fd = ((f(*xp) - f(*xm)) / (2 * h)).numpy()
        col = J[k].numpy()
        assert np.abs(col).max() > 0
        np.testing.assert_allclose(col, fd, rtol=1e-5,
                                   atol=1e-6 * np.abs(fd).max())
