"""The single-state line sum of the PyTorch port against the JAX reference's
``make_accumulate_op`` at one state: the primal, ``jvp``, ``jacfwd`` and
``jacrev`` (float64 against ``engine='jnp'``, float32 against
``engine='pallas', interpret=True``), K4's plain version against the
reference's ``basis_contract_pallas_jit`` in interpret mode, and the routing
of every transform onto the engine's primitives, proven by counting calls."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.synth import random_lines
from spectrobot_tpu.ops import opacity as jop
from spectrobot_tpu.ops.pallas_opacity import basis_contract_pallas_jit
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu_torch.kernels import launch
from spectrobot_tpu_torch.ops import cuda_basis as cb
from spectrobot_tpu_torch.ops import cuda_basis_single as cbs
from spectrobot_tpu_torch.ops import opacity as top
from spectrobot_tpu_torch.ops.cuda_opacity import Windows, line_windows

# These tests run tiny tensors: torch's intra-op threads would only
# contend (and spin-wait) with the other test workers for the cores.
torch.set_num_threads(1)

# The reference's Pallas parity budget (tests/test_pallas_opacity.py:90):
# |err| <= RTOL |ref| + ATOL_REL max|ref|; its basis-kernel and Jacobian
# budget (tests/test_pallas_jacobian.py:124): max|err| <= BASIS_REL max|ref|.
RTOL, ATOL_REL, BASIS_REL = 3e-5, 1e-6, 1e-5


@pytest.fixture(scope="module")
def fixture():
    """The tangent fixture of tests/test_pallas_jacobian.py: 150 random
    lines on 300 points, two amplitude rows, random tangents; float32 line
    inputs as numpy arrays."""
    rng = np.random.default_rng(1)
    L, P = 150, 300
    dl = j_stage(random_lines(L, 600.0, 640.0, seed=0), [(2, 1)],
                 dtype=jnp.float32, nu_ref=0.0)
    kl = jop.line_kernel_inputs(dl, 220.0, 500.0, 50.0,
                                amp_weights=jnp.ones((2, L), jnp.float32))
    f32 = lambda a: np.array(a, np.float32)      # writable copies
    nu = np.linspace(605.0, 635.0, P).astype(np.float32)
    d = dict(dnc=rng.normal(size=L) * 1e-3,
             dsx=rng.normal(size=L) * np.asarray(kl.scale_x) * 1e-2,
             dy=rng.normal(size=L) * np.asarray(kl.y) * 1e-2,
             dam=rng.normal(size=(2, L)) * np.asarray(kl.amps) * 1e-2)
    chi = rng.uniform(0.0, 0.3, L)
    return dict(nu=nu, nu0=f32(dl.nu0), nc=f32(kl.nu_c), sx=f32(kl.scale_x),
                y=f32(kl.y), amps=f32(kl.amps), chi=f32(chi),
                **{k: f32(v) for k, v in d.items()})


def _args(fx, dtype, chi):
    """(nu, nu_c, sx, y, amps[, chi_b]) as numpy arrays of ``dtype``."""
    keys = ("nu", "nc", "sx", "y", "amps") + (("chi",) if chi else ())
    return [np.asarray(fx[k], dtype) for k in keys]


def _coeffs(fx, dtype=np.float32):
    a = {k: np.asarray(fx[k], dtype) for k in
         ("sx", "amps", "dnc", "dsx", "dy", "dam")}
    return (a["dam"], a["amps"] * (-a["sx"] * a["dnc"])[None],
            a["amps"] * (a["dsx"] / a["sx"])[None], a["amps"] * a["dy"][None])


def test_basis_plain_matches_pallas_interpret(fixture):
    """K4's plain version against the reference's ``_basis_kernel`` in
    interpret mode (tests/test_pallas_jacobian.py:114), float32."""
    fx = fixture
    C = _coeffs(fx)
    ref = np.asarray(basis_contract_pallas_jit(
        *(jnp.asarray(fx[k]) for k in ("nu", "nc", "sx", "y")),
        *(jnp.asarray(c) for c in C), tile_p=128, block_l=128,
        cutoff_cm1=25.0, interpret=True))
    t = torch.as_tensor
    before = launch.LAUNCHES["basis_single_kernel"]
    got = cbs.basis_contract_single(
        t(fx["nu"]), line_windows(t(fx["nu"]), fx["nu0"]),
        *(t(fx[k]) for k in ("nc", "sx", "y")), *(t(c) for c in C))
    # CPU tensors never launch.
    assert launch.LAUNCHES["basis_single_kernel"] == before
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.max(np.abs(got.numpy() - ref)) <= BASIS_REL * np.abs(ref).max()


@pytest.mark.parametrize("with_chi", [False, True])
@pytest.mark.parametrize("cutoff", [25.0, None])
def test_basis_plain_matches_jnp_tangent(fixture, with_chi, cutoff):
    """K4's plain version against the reference's jnp tangent
    (``_tangent_via_basis``), float64."""
    fx = fixture
    nu, nc, sx, y, amps, *chi = _args(fx, np.float64, with_chi)
    d = [np.asarray(fx[k], np.float64) for k in ("dnc", "dsx", "dy", "dam")]
    chi = chi[0] if chi else None
    ref = np.asarray(jop._tangent_via_basis(
        *(jnp.asarray(a) for a in (nu, nc, sx, y, amps, *d)),
        None if chi is None else jnp.asarray(chi), chunk=64,
        variant="humlicek4", cutoff_cm1=cutoff))
    t = lambda a: None if a is None else torch.as_tensor(a)
    got = cbs.basis_contract_single_plain(
        t(nu), t(nc), t(sx), t(y), *(t(c) for c in _coeffs(fx, np.float64)),
        cutoff_cm1=cutoff, chi_b=t(chi))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10,
                               atol=1e-12 * np.abs(ref).max())


def _ops(mode, has_chi, cutoff=25.0, engine=None):
    """The reference's jnp and Pallas (interpret) ops and the port's."""
    j = jop.make_accumulate_op(engine="jnp", mode=mode, has_chi=has_chi,
                               cutoff_cm1=cutoff)
    p = jop.make_accumulate_op(engine="pallas", mode=mode, has_chi=has_chi,
                               cutoff_cm1=cutoff, interpret=True)
    t = top.make_accumulate_op(mode=mode, has_chi=has_chi, cutoff_cm1=cutoff,
                               engine=engine)
    return j, p, t


def _theta_fn(args):
    """f(theta) of the line inputs moved by four scalars (a center shift and
    relative changes of sx, y and the amplitudes): a Jacobian of 4
    columns."""
    nu, nc, sx, y, amps, *chi = args

    def f(op):
        return lambda th: op(nu, nc + th[0], sx * (1 + th[1]),
                             y * (1 + th[2]), amps * (1 + th[3]), *chi)
    return f


@pytest.mark.parametrize("n_out", [1, 3, 8])
@pytest.mark.parametrize("with_chi", [False, True])
@pytest.mark.parametrize("cutoff", [25.0, None])
def test_single_wrapper_matches_pallas_interpret(fixture, n_out, with_chi,
                                                 cutoff):
    """K3's wrapper (``ops.cuda_single.accumulate_single``, its plain route
    on the CPU) against the reference's K3 (``accumulate_pallas``, interpret
    mode) at L = 150 (not a multiple of BLOCK_L) and P = 300 (not one of
    TILE_P) with ``n_out`` random amplitude rows, float32, within the
    Pallas parity budget."""
    from spectrobot_tpu.ops.pallas_opacity import accumulate_pallas
    from spectrobot_tpu_torch.ops.cuda_single import accumulate_single
    rng = np.random.default_rng(20 + n_out)
    fx = fixture
    amps = (fx["amps"][:1] * rng.uniform(0.5, 1.5, (n_out, fx["nc"].size))
            ).astype(np.float32)
    chi = fx["chi"] if with_chi else None
    ref = np.asarray(accumulate_pallas(
        jnp.asarray(fx["nu"]), jop.KernelLines(
            *(jnp.asarray(fx[k]) for k in ("nc", "sx", "y")),
            jnp.asarray(amps), None if chi is None else jnp.asarray(chi)),
        cutoff_cm1=cutoff, interpret=True))
    t = torch.as_tensor
    win = line_windows(t(fx["nu"]), fx["nu0"], cutoff_cm1=cutoff)
    got = accumulate_single(t(fx["nu"]), win, t(fx["nc"]), t(fx["sx"]),
                            t(fx["y"]), t(amps), cutoff_cm1=cutoff,
                            chi_b=None if chi is None else t(chi)).numpy()
    assert got.dtype == np.float32
    assert got.shape == ref.shape == (n_out, 300)
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=ATOL_REL * np.abs(ref).max())


@pytest.mark.parametrize("with_chi", [False, True])
@pytest.mark.parametrize("cutoff", [25.0, None])
def test_primal_matches_jax(fixture, with_chi, cutoff):
    """The op's values: float64 against engine='jnp' within 1e-10 of
    max|ref|, float32 against the Pallas kernel in interpret mode within
    the Pallas parity budget."""
    j, p, t = _ops("fwd", with_chi, cutoff)
    a64 = _args(fixture, np.float64, with_chi)
    ref = np.asarray(j(*(jnp.asarray(a) for a in a64)))
    got = t(*(torch.as_tensor(a) for a in a64)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10 * np.abs(ref).max())
    a32 = _args(fixture, np.float32, with_chi)
    ref = np.asarray(p(*(jnp.asarray(a) for a in a32)))
    got = t(*(torch.as_tensor(a) for a in a32)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=ATOL_REL * np.abs(ref).max())


@pytest.mark.parametrize("with_chi", [False, True])
def test_jvp_matches_jax(fixture, with_chi):
    """One tangent by ``torch.func.jvp`` against ``jax.jvp``: float64 (jnp)
    within 1e-8 of max|ref|, float32 (Pallas, interpret) within the basis
    budget."""
    j, p, t = _ops("fwd", with_chi)
    d = [fixture[k] for k in ("dnc", "dsx", "dy", "dam")]
    for dtype, jop_, tol in ((np.float64, j, 1e-8), (np.float32, p,
                                                    BASIS_REL)):
        args = _args(fixture, dtype, with_chi)
        tang = [np.asarray(v, dtype) for v in d]
        if with_chi:
            tang.append(np.zeros_like(args[-1]))
        _, ref = jax.jvp(lambda *a: jop_(jnp.asarray(args[0]), *a),
                         tuple(jnp.asarray(a) for a in args[1:]),
                         tuple(jnp.asarray(v) for v in tang))
        tt = torch.as_tensor
        _, got = torch.func.jvp(lambda *a: t(tt(args[0]), *a),
                                tuple(tt(a) for a in args[1:]),
                                tuple(tt(v) for v in tang))
        ref = np.asarray(ref)
        assert np.max(np.abs(got.numpy() - ref)) <= tol * np.abs(ref).max()


@pytest.mark.parametrize("mode", ["fwd", "rev"])
@pytest.mark.parametrize("with_chi", [False, True])
def test_jacobian_matches_jax(fixture, mode, with_chi):
    """The 4-column Jacobian (``jacfwd`` in mode 'fwd', ``jacrev`` in mode
    'rev') against the reference's, float64 within 1e-8 of max|J|."""
    j, _, t = _ops(mode, with_chi)
    jac_j = jax.jacfwd if mode == "fwd" else jax.jacrev
    jac_t = torch.func.jacfwd if mode == "fwd" else torch.func.jacrev
    args = _args(fixture, np.float64, with_chi)
    th = np.zeros(4)
    ref = np.asarray(jac_j(_theta_fn([jnp.asarray(a) for a in args])(j))(
        jnp.asarray(th)))
    got = jac_t(_theta_fn([torch.as_tensor(a) for a in args])(t))(
        torch.as_tensor(th)).numpy()
    assert got.shape == ref.shape == (2, 300, 4)
    assert np.max(np.abs(got - ref)) <= 1e-8 * np.abs(ref).max()


class _Counting:
    """An engine over the plain versions that records every call: the
    primitive's name and its state and row counts."""

    def __init__(self):
        self.calls = []
        p = cb.PLAIN

        def rec(name, fn, rows_at):
            def call(*args, **kw):
                # Every call gets the window table of its grid and lines,
                # built inside the Function (also under torch.func).
                assert isinstance(args[1], Windows)
                assert args[1].n_lines == args[2].shape[-1]
                self.calls.append((name, tuple(args[2].shape),
                                   tuple(args[rows_at].shape)))
                return fn(*args, **kw)
            return call

        self.engine = top.Engine(
            "counting", rec("accumulate", p.accumulate, 5),
            rec("contract", p.contract, 5), rec("transpose", p.transpose, 5),
            None, rec("accumulate_single", p.accumulate_single, 5),
            rec("contract_single", p.contract_single, 5))

    def names(self):
        names = [c[0] for c in self.calls]
        self.calls.clear()
        return names


def test_transforms_route_to_the_primitives(fixture):
    """Each transform of the single-state op, counted on the plain engine:
    jacfwd one accumulate_single and one contract_single (every column
    folded into its rows), jvp the same, a structural vmap (once or twice
    nested) one batched accumulate, jacfwd of a vmap and vmap of a jacfwd
    one accumulate and one contract, reverse mode one accumulate_single
    and one transpose at B = 1 per gradient and per jacrev."""
    cnt = _Counting()
    nu, nc, sx, y, amps = (torch.as_tensor(a) for a in
                           _args(fixture, np.float64, False))
    op = top.make_accumulate_op(engine=cnt.engine)
    f = _theta_fn([nu, nc, sx, y, amps])(op)
    th = torch.zeros(4, dtype=torch.float64)
    J = torch.func.jacfwd(f)(th)
    rows = [c[2] for c in cnt.calls if c[0] == "contract_single"]
    assert cnt.names() == ["accumulate_single", "contract_single"]
    assert rows == [(4 * 2, 150)]
    _, col = torch.func.jvp(f, (th,), (torch.eye(4, dtype=th.dtype)[1],))
    assert cnt.names() == ["accumulate_single", "contract_single"]
    np.testing.assert_allclose(col.numpy(), J[..., 1].numpy(), rtol=1e-12,
                               atol=1e-14 * float(J.abs().max()))

    ths = torch.as_tensor(np.linspace(-0.1, 0.1, 12).reshape(3, 4) * 1e-2)
    out = torch.func.vmap(f)(ths)
    assert [c[:2] for c in cnt.calls] == [("accumulate", (3, 150))]
    assert cnt.names() == ["accumulate"]
    np.testing.assert_allclose(out[2].numpy(), f(ths[2]).numpy(),
                               rtol=1e-13, atol=0)
    cnt.names()
    out2 = torch.func.vmap(torch.func.vmap(f))(ths.reshape(3, 1, 4)
                                               .expand(3, 2, 4))
    assert [c[:2] for c in cnt.calls] == [("accumulate", (6, 150))]
    cnt.names()
    np.testing.assert_allclose(out2[:, 1].numpy(), out.numpy(), rtol=1e-13,
                               atol=0)
    Jv = torch.func.jacfwd(torch.func.vmap(f))(ths)
    assert cnt.names() == ["accumulate", "contract"]
    vJ = torch.func.vmap(torch.func.jacfwd(f))(ths)
    assert cnt.names() == ["accumulate", "contract"]
    for k in range(3):
        np.testing.assert_allclose(vJ[k].numpy(), Jv[k, ..., k, :].numpy(),
                                   rtol=1e-12, atol=1e-14 * float(
                                       vJ.abs().max()))

    rev = _theta_fn([nu, nc, sx, y, amps])(
        top.make_accumulate_op(engine=cnt.engine, mode="rev"))
    x = th.clone().requires_grad_()
    g = torch.autograd.grad(rev(x).sum(), x)[0]
    calls = list(cnt.calls)
    assert cnt.names() == ["accumulate_single", "transpose"]
    assert calls[1][1:] == ((1, 150), (1, 2, 300))     # B = 1, R = 2
    Jr = torch.func.jacrev(rev)(th)
    calls = list(cnt.calls)
    assert cnt.names() == ["accumulate_single", "transpose"]
    assert calls[1][2] == (1, 2 * 2 * 300, 300)          # every cotangent
    np.testing.assert_allclose(g.numpy(), J.sum(dim=(0, 1)).numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(Jr.numpy(), J.numpy(), rtol=1e-10,
                               atol=1e-12 * float(J.abs().max()))
    gv = torch.func.vmap(torch.func.grad(lambda t_: rev(t_).sum()))(ths)
    assert cnt.names() == ["accumulate", "transpose"]
    for k in range(3):
        x = ths[k].clone().requires_grad_()
        np.testing.assert_allclose(
            gv[k].numpy(), torch.autograd.grad(rev(x).sum(), x)[0].numpy(),
            rtol=1e-12)


def test_batched_grid_maps_over_its_elements(fixture):
    """A vmap that batches the grid has no flat form: one call per
    element, as the reference's lax.map."""
    cnt = _Counting()
    nu, nc, sx, y, amps = (torch.as_tensor(a) for a in
                           _args(fixture, np.float64, False))
    op = top.make_accumulate_op(engine=cnt.engine)
    grids = torch.stack([nu, nu + 0.5])
    out = torch.func.vmap(lambda g: op(g, nc, sx, y, amps))(grids)
    assert cnt.names() == ["accumulate_single"] * 2
    np.testing.assert_allclose(out[1].numpy(),
                               op(nu + 0.5, nc, sx, y, amps).numpy(),
                               rtol=1e-14, atol=0)


def test_op_refuses_what_it_does_not_take(fixture):
    nu, nc, sx, y, amps, chi = (torch.as_tensor(a) for a in
                                _args(fixture, np.float64, True))
    with pytest.raises(ValueError, match="mode"):
        top.make_accumulate_op(mode="both")
    with pytest.raises(ValueError, match="has_chi=False"):
        top.make_accumulate_op()(nu, nc, sx, y, amps, chi)
    rev = top.make_accumulate_op(mode="rev")
    with pytest.raises(NotImplementedError, match="forward-mode"):
        torch.func.jvp(lambda s: rev(nu, nc, s, y, amps), (sx,), (sx,))
