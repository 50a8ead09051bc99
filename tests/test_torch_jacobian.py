"""The Jacobian slice of the PyTorch port against the JAX reference: the
basis and its contraction (K2's plain version against the Pallas kernel in
interpret mode), the analytic tangent, torch.func.jacfwd of the limb forward
against jax.jacfwd, the one-contraction-per-Jacobian fold, and the
finite-difference check of acceptance config 4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band, random_lines
from spectrobot_tpu.ops import opacity as jop
from spectrobot_tpu.ops.ils import ils_matrix
from spectrobot_tpu.ops.pallas_opacity import basis_contract_pallas_batch_jit
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu.retrieval import state as jstate
from spectrobot_tpu_torch import interop
from spectrobot_tpu_torch.data.atmosphere import MARS
from spectrobot_tpu_torch.kernels import launch
from spectrobot_tpu_torch.ops import cuda_basis as cb
from spectrobot_tpu_torch.ops import opacity as top
from spectrobot_tpu_torch.ops.cuda_opacity import line_windows
from spectrobot_tpu_torch.retrieval import state as tstate

CPU = torch.device("cpu")
# These tests run tiny tensors: torch's intra-op threads would only
# contend (and spin-wait) with the other test workers for the cores.
torch.set_num_threads(1)


def _numpy(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def basis_case():
    """Three states of 150 random lines on 300 points (float32), with
    random nonzero coefficient rows for 3 tangents x 2 depths."""
    rng = np.random.default_rng(1)
    L, P, B = 150, 300, 3
    dl = j_stage(random_lines(L, 600.0, 640.0, seed=0), [(2, 1)],
                 dtype=jnp.float32, nu_ref=0.0)
    kl = jop.line_kernel_inputs(dl, 220.0, 500.0, 50.0,
                                amp_weights=jnp.ones((2, L), jnp.float32))
    f32 = lambda a: np.asarray(a, np.float32)
    nc = f32([np.asarray(kl.nu_c) + 0.01 * b for b in range(B)])
    sx = f32([np.asarray(kl.scale_x) * (1 + 0.05 * b) for b in range(B)])
    y = f32([np.asarray(kl.y) * (1 + 0.1 * b) for b in range(B)])
    amps = np.asarray(kl.amps, np.float32)
    C = [f32(rng.normal(size=(B, 6, L)) * amps[0]) for _ in range(4)]
    nu = np.linspace(605.0, 635.0, P).astype(np.float32)
    return nu, np.asarray(dl.nu0, np.float32), nc, sx, y, C


def test_basis_contract_plain_matches_pallas_interpret(basis_case):
    nu, nu0, nc, sx, y, C = basis_case
    ref = np.asarray(basis_contract_pallas_batch_jit(
        jnp.asarray(nu), jnp.asarray(nc), jnp.asarray(sx), jnp.asarray(y),
        *(jnp.asarray(c) for c in C), cutoff_cm1=25.0, interpret=True))
    t = torch.as_tensor
    before = launch.LAUNCHES["basis_batch_kernel"]
    got = cb.basis_contract_batch(
        t(nu), line_windows(t(nu), nu0), t(nc), t(sx), t(y),
        *(t(c) for c in C))
    # CPU tensors never launch.
    assert launch.LAUNCHES["basis_batch_kernel"] == before
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("with_chi", [False, True])
def test_tangent_via_basis_matches_jax(basis_case, with_chi):
    """The plain tangent and the plain contraction against the reference's
    jnp basis path, one state per call, float64."""
    nu, _, nc, sx, y, C = basis_case
    rng = np.random.default_rng(4)
    L = nc.shape[1]
    chi = rng.uniform(0.0, 0.3, L) if with_chi else None
    amps = np.abs(C[0][0, :2]).astype(np.float64)
    d = [rng.normal(size=L) * s for s in (1e-3, sx[0] * 1e-2, y[0] * 1e-2)]
    dam = rng.normal(size=(2, L)) * amps * 1e-2
    f64 = lambda a: None if a is None else np.asarray(a, np.float64)
    args = [f64(a) for a in (nu, nc[0], sx[0], y[0], amps, *d, dam)]
    ref = np.asarray(jop._tangent_via_basis(
        *(jnp.asarray(a) for a in args),
        None if chi is None else jnp.asarray(chi), chunk=64,
        variant="humlicek4", cutoff_cm1=25.0))
    t = lambda a: None if a is None else torch.as_tensor(a)
    got = top._tangent_via_basis(*(t(a) for a in args), t(chi), chunk=64,
                                 cutoff_cm1=25.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10,
                               atol=1e-12 * np.abs(ref).max())
    rows = top.basis_coefficients(*(t(a)[None] for a in (args[2], args[4],
                                                         *args[5:])))
    cont = cb.basis_contract_batch_plain(
        t(args[0]), *(t(a)[None] for a in args[1:4]), *rows,
        chi_b=None if chi is None else t(chi)[None])
    np.testing.assert_allclose(cont[0].numpy(), ref, rtol=1e-10,
                               atol=1e-12 * np.abs(ref).max())


def _limb_pair(dtype):
    """The same small limb scene in both packages: T -> radiances (plain
    line sum in the port, engine='jnp' in the reference)."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    atm = mars_standard_atmosphere(n_lev=6, z_top=80e3)
    atm = jax.tree.map(lambda a: jnp.asarray(a, jdt), atm)
    dl = j_stage(co2_15um_band(j_max=16), [(2, 1)], dtype=jdt)
    nu64 = np.linspace(620.0, 680.0, 160)
    ths = np.linspace(10e3, 60e3, 3)
    jf = jstate.build_forward(
        atm, dl, jnp.asarray(nu64, jdt), ["CO2"], J_MARS,
        tangent_heights_m=jnp.asarray(ths, jdt), n_sub=2,
        nu_off=jnp.asarray(nu64 - float(dl.nu_ref), jdt), engine="jnp")
    tatm = interop.atmosphere_from_numpy(
        {**{k: np.asarray(getattr(atm, k)) for k in ("z", "p", "T", "n")},
         "vmr": {k: np.asarray(v) for k, v in atm.vmr.items()}}, device=CPU)
    tl = interop.device_lines_from_numpy(_numpy(dl), device=CPU)
    tf = tstate.build_forward(
        tatm, tl, torch.as_tensor(nu64, dtype=dtype), ["CO2"], MARS,
        tangent_heights_m=torch.as_tensor(ths, dtype=dtype), n_sub=2,
        nu_off=torch.as_tensor(nu64 - float(dl.nu_ref), dtype=dtype),
        engine=cb.PLAIN)
    T0 = np.array(atm.T)          # a writable copy for torch.as_tensor
    j = lambda T: jf({"T": T, "ln_vmr": {}})
    t = lambda T: tf({"T": T, "ln_vmr": {}})
    return j, t, T0


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-8),
                                        (torch.float32, 1e-5)])
def test_jacfwd_limb_matches_jax(dtype, rtol):
    jf, tf, T0 = _limb_pair(dtype)
    J_ref = np.asarray(jax.jacfwd(jf)(jnp.asarray(T0)))
    J = torch.func.jacfwd(tf)(torch.as_tensor(T0)).numpy()
    assert J.dtype == J_ref.dtype and J.shape == J_ref.shape
    assert np.isfinite(J).all()
    assert np.max(np.abs(J - J_ref)) <= rtol * np.abs(J_ref).max()


class _CountingContract:
    """A contract primitive that records the rows of every call."""

    def __init__(self):
        self.rows = []

    def __call__(self, *args, **kw):
        self.rows.append(args[5].shape[1])
        return cb.PLAIN.contract(*args, **kw)


def test_jacfwd_makes_one_contraction_of_all_columns():
    """An N-column torch.func.jacfwd runs the line sum's primal once and
    its tangent as ONE contraction with R = 2N rows; the chunked Jacobian
    gives the same matrix."""
    _, _, T0 = _limb_pair(torch.float64)
    count = _CountingContract()
    engine = top.Engine("counting", cb.PLAIN.accumulate, count)
    atm = mars_standard_atmosphere(n_lev=6, z_top=80e3)
    tatm = interop.atmosphere_from_numpy(
        {**{k: np.asarray(getattr(atm, k)) for k in ("z", "p", "T", "n")},
         "vmr": {k: np.asarray(v) for k, v in atm.vmr.items()}}, device=CPU)
    dl = j_stage(co2_15um_band(j_max=16), [(2, 1)], dtype=jnp.float64)
    tl = interop.device_lines_from_numpy(_numpy(dl), device=CPU)
    nu = torch.as_tensor(np.linspace(620.0, 680.0, 160))
    fwd = tstate.build_forward(tatm, tl, nu, ["CO2"], MARS,
                               tangent_heights_m=torch.as_tensor([2e4, 5e4]),
                               n_sub=2, engine=engine)
    f = lambda T: fwd({"T": T, "ln_vmr": {}})
    x = torch.as_tensor(T0)
    N = x.shape[0]
    J = tstate.jacobian_fwd(f, x)
    assert count.rows == [2 * N]
    count.rows.clear()
    J_ch = tstate.jacobian_fwd_chunked(f, x, chunk=5)
    assert count.rows == [10, 2 * (N - 5)]
    np.testing.assert_allclose(J_ch.numpy(), J.numpy(), rtol=1e-12,
                               atol=1e-14 * float(J.abs().max()))
    # The jvp of one column equals that column.
    v = torch.zeros_like(x)
    v[2] = 1.0
    _, col = torch.func.jvp(f, (x,), (v,))
    np.testing.assert_allclose(col.numpy(), J[:, 2].numpy(), rtol=1e-12,
                               atol=1e-14 * float(J.abs().max()))


def test_line_sum_refuses_a_structural_vmap():
    """The batched line sum once refused a structural vmap; it now flattens
    the vmap batch into its state axis (the reference's ``accB_rule``): one
    accumulate call on [n*B, L] states, equal to the calls state by
    state."""
    calls = []

    def accumulate(*args, **kw):
        calls.append(tuple(args[2].shape))
        return cb.PLAIN.accumulate(*args, **kw)

    nu = torch.linspace(-5.0, 5.0, 16, dtype=torch.float64)
    op = top.LineSumOp(top.Engine("counting", accumulate, None), None, 25.0)
    rng = np.random.default_rng(0)
    lines = torch.as_tensor(rng.uniform(0.5, 1.5, (2, 3, 4)))
    f = lambda a: op(nu, a, a, a, a[:, None].expand(3, 2, 4).contiguous())
    out = torch.func.vmap(f)(lines)
    assert calls == [(6, 4)]
    assert out.shape == (2, 3, 2, 16)
    for k in range(2):
        np.testing.assert_allclose(out[k].numpy(), f(lines[k]).numpy(),
                                   rtol=1e-14, atol=0.0)


def _config4(dtype):
    """Acceptance config 4 with humlicek4: T and ln VMR(CO2) of an 8-level
    limb scene, 3 rays, 23 ILS channels."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    atm = mars_standard_atmosphere(n_lev=8, z_top=70e3)
    dl = j_stage(co2_15um_band(j_max=10), [(2, 1)], dtype=jdt)
    nu64 = np.linspace(660.0, 675.0, 301)
    W = ils_matrix(nu64, np.linspace(662, 673, 23), 0.7)
    tatm = interop.atmosphere_from_numpy(
        {**{k: np.asarray(getattr(atm, k)) for k in ("z", "p", "T", "n")},
         "vmr": {k: np.asarray(v) for k, v in atm.vmr.items()}},
        device=CPU).to(dtype)
    tl = interop.device_lines_from_numpy(_numpy(dl), device=CPU)
    fwd = tstate.build_forward(
        tatm, tl, torch.as_tensor(nu64, dtype=dtype), ["CO2"], MARS,
        tangent_heights_m=torch.as_tensor([8e3, 25e3, 45e3], dtype=dtype),
        ils_W=torch.as_tensor(W, dtype=dtype), n_sub=2)
    x0, unravel = tstate.flatten_state(tstate.make_state(tatm, ["CO2"]))
    return lambda x: fwd(unravel(x)), x0


def test_config4_jacobian_matches_finite_difference():
    fwd_flat, x0 = _config4(torch.float64)
    K = tstate.jacobian_fwd(fwd_flat, x0).numpy()
    K_fd = tstate.jacobian_fd(fwd_flat, x0, eps=3e-5)
    assert K.shape == K_fd.shape == (3 * 23, x0.shape[0])
    assert np.isfinite(K).all()
    assert np.abs(K[:, :8]).max() > 0 and np.abs(K[:, 8:]).max() > 0
    scale = np.abs(K).max(axis=0, keepdims=True)
    # The reference's config-4 tolerance (tests/test_jacobian_config4.py).
    np.testing.assert_allclose(K, K_fd, atol=1e-4 * scale.max(axis=1).max(),
                               rtol=5e-4)
