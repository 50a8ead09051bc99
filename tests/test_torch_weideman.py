"""The Weideman evaluator through the port's line sums (ops/opacity.py, the
plain versions of ops/cuda_*.py and the ``WEIDEMAN`` engine) against the
JAX reference's ``engine='jnp'``, ``variant='weideman'`` counterparts, in
float64: the plain line sum, the basis, its contraction and transpose, one
state; ``make_accumulate_op`` in both modes (tests/test_analytic_jvp.py's
Weideman cases); ``cross_sections`` and config 1 (also against the golden
oracle); the limb forward, its Jacobian and reverse gradient; the LTE and
non-LTE table builds and their fingerprints; and the nu-halo mesh on two
gloo ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import numpy_ref
from spectrobot_tpu.data import tips
from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.forward.geometry import limb_path_cg as j_limb_cg
from spectrobot_tpu.forward.limb import limb_radiance as j_limb_radiance
from spectrobot_tpu.forward.model import nadir_single_layer as j_nadir
from spectrobot_tpu.ops import lut as jlut
from spectrobot_tpu.ops import opacity as jop
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as jstage
from spectrobot_tpu.retrieval import state as jstate
from spectrobot_tpu_torch import interop
from spectrobot_tpu_torch.data.atmosphere import MARS
from spectrobot_tpu_torch.forward.limb import limb_radiance
from spectrobot_tpu_torch.forward.model import nadir_single_layer
from spectrobot_tpu_torch.ops import cuda_basis as cb
from spectrobot_tpu_torch.ops import cuda_basis_single as cbs
from spectrobot_tpu_torch.ops import cuda_single as cs
from spectrobot_tpu_torch.ops import cuda_transpose as ctr
from spectrobot_tpu_torch.ops import lut as tlut
from spectrobot_tpu_torch.ops import opacity as top
from spectrobot_tpu_torch.retrieval import state as tstate

import torch_mesh_cases as cases

torch.set_num_threads(1)

CPU = torch.device("cpu")
# float64 parity with the reference: within TOL of max |ref|.
TOL = 1e-10
W = "weideman"


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def _numpy(nt) -> dict:
    return {k: (v if v is None or isinstance(v, (bool, int))
                else np.asarray(v)) for k, v in nt._asdict().items()}


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def states():
    """Three (T, p) states of the 15 um band's kernel inputs (nu_ref = 0)
    over 300 points, two amplitude rows each, random chi slopes and
    tangents (numpy, seeded)."""
    dl = jstage(co2_15um_band(j_max=10), [(2, 1)], dtype=jnp.float64,
                nu_ref=0.0)
    rng = np.random.default_rng(0)
    kls = [jop.line_kernel_inputs(
        dl, T, p, 0.3 * p, amp_weights=jnp.asarray(
            rng.uniform(0.5, 1.5, (2, dl.n_lines))))
        for T, p in ((150.0, 30.0), (230.0, 250.0), (290.0, 900.0))]
    kl = {f: np.stack([np.asarray(getattr(k, f)) for k in kls])
          for f in ("nu_c", "scale_x", "y", "amps")}
    L = dl.n_lines
    return {"nu": np.linspace(660.0, 674.0, 300), "kl": kl,
            "chi_b": rng.uniform(0.0, 0.3, (3, L)),
            "d": [rng.standard_normal((3, L)) * kl["nu_c"].std(),
                  rng.standard_normal((3, L)) * kl["scale_x"].std(),
                  rng.standard_normal((3, L)) * kl["y"].std(),
                  rng.standard_normal((3, 2, L)) * kl["amps"].std()],
            "ct": rng.standard_normal((3, 2, 300))}


def _state(st, b, chi):
    kl = st["kl"]
    return (kl["nu_c"][b], kl["scale_x"][b], kl["y"][b], kl["amps"][b],
            st["chi_b"][b] if chi else None)


@pytest.mark.parametrize("cutoff,chi", [(25.0, False), (25.0, True),
                                        (None, False)])
def test_line_sum_matches_jax(states, cutoff, chi):
    """The batched plain line sum (``WEIDEMAN.accumulate``) and the
    single-state one against ``accumulate_jnp`` of each state."""
    nu, kl = states["nu"], states["kl"]
    ref = np.stack([np.asarray(jop.accumulate_jnp(
        jnp.asarray(nu), jop.KernelLines(*(None if a is None else
                                           jnp.asarray(a)
                                           for a in _state(states, b, chi))),
        chunk=64, variant=W, cutoff_cm1=cutoff)) for b in range(3)])
    chi_b = _t(states["chi_b"]) if chi else None
    got = cb.WEIDEMAN.accumulate(
        _t(nu), None, _t(kl["nu_c"]), _t(kl["scale_x"]), _t(kl["y"]),
        _t(kl["amps"]), cutoff_cm1=cutoff, chi_b=chi_b)
    _close(got, ref)
    for b in range(3):
        one = cs.accumulate_single_plain(
            _t(nu), *(None if a is None else _t(a)
                      for a in _state(states, b, chi)[:4]),
            cutoff_cm1=cutoff, chi_b=None if chi_b is None else chi_b[b],
            variant=W)
        _close(one, ref[b])
    # The humlicek4 engine's sum differs by the approximants' gap.
    h = cb.PLAIN.accumulate(_t(nu), None, _t(kl["nu_c"]), _t(kl["scale_x"]),
                            _t(kl["y"]), _t(kl["amps"]), cutoff_cm1=cutoff,
                            chi_b=chi_b)
    assert float((h - got).abs().max()) > 1e-8 * float(got.abs().max())


def test_basis_matches_jax(states):
    """The basis (K, Kx, xKx, Ky) from ``wofz_weideman_grad`` at every pair
    of one state."""
    nu = states["nu"]
    nc, sx, y, _, cbv = _state(states, 1, True)
    ref = jop._basis(jnp.asarray(nu), jnp.asarray(nc), jnp.asarray(sx),
                     jnp.asarray(y), jnp.asarray(cbv), variant=W,
                     cutoff_cm1=25.0, dt=jnp.float64)
    got = top._basis(_t(nu), _t(nc), _t(sx), _t(y), _t(cbv),
                     cutoff_cm1=25.0, variant=W)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("chi", [False, True])
def test_basis_contraction_matches_jax(states, chi):
    """The tangent of one random direction through the batched and the
    single-state plain contraction (``WEIDEMAN.contract``,
    ``contract_single``) against ``_tangent_via_basis``."""
    nu, kl, d = states["nu"], states["kl"], states["d"]
    ref = np.stack([np.asarray(jop._tangent_via_basis(
        jnp.asarray(nu), *(jnp.asarray(a) for a in _state(states, b, chi)[:4]),
        *(jnp.asarray(a[b]) for a in d),
        jnp.asarray(states["chi_b"][b]) if chi else None,
        chunk=64, variant=W, cutoff_cm1=25.0)) for b in range(3)])
    C = top.basis_coefficients(_t(kl["scale_x"]), _t(kl["amps"]),
                               *(_t(a) for a in d))
    chi_b = _t(states["chi_b"]) if chi else None
    got = cb.WEIDEMAN.contract(_t(nu), None, _t(kl["nu_c"]),
                               _t(kl["scale_x"]), _t(kl["y"]), *C,
                               cutoff_cm1=25.0, chi_b=chi_b)
    _close(got, ref)
    for b in range(3):
        one = cb.WEIDEMAN.contract_single(
            _t(nu), None, _t(kl["nu_c"][b]), _t(kl["scale_x"][b]),
            _t(kl["y"][b]), *(c[b] for c in C), cutoff_cm1=25.0,
            chi_b=None if chi_b is None else chi_b[b])
        _close(one, ref[b])
        _close(cbs.basis_contract_single_plain(
            _t(nu), _t(kl["nu_c"][b]), _t(kl["scale_x"][b]), _t(kl["y"][b]),
            *(c[b] for c in C), chi_b=None if chi_b is None else chi_b[b],
            variant=W), ref[b])


def test_transpose_matches_jax(states):
    """The cotangents of the line inputs through the plain transpose
    (``WEIDEMAN.transpose`` and ``transpose_epilogue``) against
    ``_tangent_transpose``."""
    nu, kl, ct = states["nu"], states["kl"], states["ct"]
    Ab = cb.WEIDEMAN.transpose(_t(nu), None, _t(kl["nu_c"]),
                               _t(kl["scale_x"]), _t(kl["y"]), _t(ct),
                               cutoff_cm1=25.0, chi_b=_t(states["chi_b"]))
    got = top.transpose_epilogue(_t(kl["scale_x"]), _t(kl["amps"]), *Ab)
    for b in range(3):
        ref = jop._tangent_transpose(
            jnp.asarray(nu), *(jnp.asarray(a) for a in _state(states, b,
                                                              True)[:4]),
            jnp.asarray(ct[b]), jnp.asarray(states["chi_b"][b]), chunk=64,
            variant=W, cutoff_cm1=25.0)
        for g, r in zip(got, ref):
            _close(g[b], r)
    plain = ctr.basis_transpose_batch_plain(
        _t(nu), _t(kl["nu_c"]), _t(kl["scale_x"]), _t(kl["y"]), _t(ct),
        chi_b=_t(states["chi_b"]), variant=W)
    for a, p in zip(Ab, plain):
        assert torch.equal(a, p)


# ---------------------------------------------------------------------------
# make_accumulate_op: tests/test_analytic_jvp.py's Weideman cases
# ---------------------------------------------------------------------------


def _op_inputs(j_max=10):
    dl = jstage(co2_15um_band(j_max=j_max), [(2, 1)], dtype=jnp.float64,
                nu_ref=0.0)
    kl = jop.line_kernel_inputs(dl, 230.0, 250.0, 100.0,
                                amp_weights=jnp.ones((2, dl.n_lines)))
    return np.linspace(660.0, 674.0, 300), [np.asarray(a) for a in kl[:4]]


@pytest.mark.parametrize("cutoff", [25.0, None])
def test_accumulate_op_jvp_matches_jax(cutoff):
    """jvp through the op in mode 'fwd' against the reference op's, and
    against plain autograd of the same Weideman primal within the
    reference test's budget."""
    nu, args = _op_inputs()
    rng = np.random.default_rng(0)
    tans = [rng.standard_normal(a.shape) * a.std() + 1e-12 for a in args]
    jop_f = jop.make_accumulate_op(chunk=64, cutoff_cm1=cutoff, variant=W)
    p_ref, t_ref = jax.jvp(lambda *a: jop_f(jnp.asarray(nu), *a),
                           tuple(map(jnp.asarray, args)),
                           tuple(map(jnp.asarray, tans)))
    op = top.make_accumulate_op(cutoff_cm1=cutoff, variant=W)
    assert op.engine is cb.WEIDEMAN
    p, t = torch.func.jvp(lambda *a: op(_t(nu), *a), tuple(map(_t, args)),
                          tuple(map(_t, tans)))
    _close(p, p_ref)
    _close(t, t_ref)
    plain = lambda *a: top.line_sum_plain_ad(_t(nu), *a, chunk=64,
                                             cutoff_cm1=cutoff, variant=W)
    p2, t2 = torch.func.jvp(plain, tuple(map(_t, args)), tuple(map(_t, tans)))
    np.testing.assert_allclose(p.numpy(), p2.numpy(), rtol=1e-12)
    np.testing.assert_allclose(t.numpy(), t2.numpy(), rtol=2e-5,
                               atol=float(t2.abs().max()) * 1e-7)


def _prologue_fn(op, dl, nu):
    def g(T):
        kl = top.line_kernel_inputs(dl, T, 300.0, 50.0,
                                    amp_weights=torch.ones((2, dl.n_lines),
                                                           dtype=T.dtype))
        return op(nu, kl.nu_c, kl.scale_x, kl.y, kl.amps)
    return g


def test_accumulate_op_jacobians_through_prologue():
    """jacfwd (mode 'fwd') and jacrev (mode 'rev') in T through the
    strength/width prologue against the reference's, and against each
    other as the reference test holds them."""
    jdl = jstage(co2_15um_band(j_max=8), [(2, 1)], dtype=jnp.float64,
                 nu_ref=0.0)
    dl = interop.device_lines_from_numpy(_numpy(jdl), device=CPU)
    nu = np.linspace(662.0, 672.0, 200)

    def jf(op):
        def g(T):
            kl = jop.line_kernel_inputs(jdl, T, 300.0, 50.0,
                                        amp_weights=jnp.ones((2, jdl.n_lines)))
            return op(jnp.asarray(nu), kl.nu_c, kl.scale_x, kl.y, kl.amps)
        return g

    J_ref = jax.jacfwd(jf(jop.make_accumulate_op(chunk=64, variant=W)))(
        jnp.asarray(230.0))
    T0 = torch.tensor(230.0, dtype=torch.float64)
    Jf = torch.func.jacfwd(_prologue_fn(
        top.make_accumulate_op(variant=W), dl, _t(nu)))(T0)
    Jr = torch.func.jacrev(_prologue_fn(
        top.make_accumulate_op(variant=W, mode="rev"), dl, _t(nu)))(T0)
    _close(Jf, J_ref)
    _close(Jr, J_ref)
    np.testing.assert_allclose(Jr.numpy(), Jf.numpy(), rtol=1e-9,
                               atol=float(Jf.abs().max()) * 1e-12)


def test_accumulate_op_grad_matches_jax():
    """The gradient through the op in mode 'rev' against the reference
    op's, and against plain autograd within the reference test's budget."""
    nu, args = _op_inputs()
    wgt = np.random.default_rng(2).standard_normal((2, nu.shape[0]))
    jop_r = jop.make_accumulate_op(chunk=64, variant=W, mode="rev")
    g_ref = jax.grad(lambda *a: jnp.sum(jnp.asarray(wgt) * jop_r(
        jnp.asarray(nu), *a)), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, args))
    op = top.make_accumulate_op(variant=W, mode="rev")
    xs = [_t(a).requires_grad_() for a in args]
    g = torch.autograd.grad(torch.sum(_t(wgt) * op(_t(nu), *xs)), xs)
    xp = [_t(a).requires_grad_() for a in args]
    gp = torch.autograd.grad(torch.sum(_t(wgt) * top.line_sum_plain_ad(
        _t(nu), *xp, variant=W)), xp)
    for a, r, p in zip(g, g_ref, gp):
        _close(a, r)
        np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=2e-5,
                                   atol=float(p.abs().max()) * 1e-7)


def test_engine_carries_the_variant(states):
    """An engine of another variant is refused, as the reference refuses
    engine='pallas' with variant='weideman'; with no engine given each
    variant takes its own."""
    nu = _t(states["nu"])
    dl = interop.device_lines_from_numpy(_numpy(jstage(
        co2_15um_band(j_max=4), [(2, 1)], dtype=jnp.float64)), device=CPU)
    for engine in (cb.KERNELS, cb.PLAIN):
        with pytest.raises(ValueError, match="evaluates humlicek4 only"):
            top.make_accumulate_op(variant=W, engine=engine)
        with pytest.raises(ValueError, match="evaluates humlicek4 only"):
            top.cross_sections(nu, dl, 200.0, 300.0, variant=W,
                               engine=engine)
        with pytest.raises(ValueError, match="evaluates humlicek4 only"):
            tlut.build_lut(nu, dl, 1, n_T=2, n_p=2, variant=W, engine=engine)
    with pytest.raises(ValueError, match="evaluates weideman only"):
        top.make_accumulate_op(engine=cb.WEIDEMAN)
    with pytest.raises(ValueError, match="unknown voigt variant"):
        top.cross_sections(nu, dl, 200.0, 300.0, variant="voigt")
    assert cb.engine_for(W) is cb.WEIDEMAN
    assert cb.engine_for("humlicek4") is cb.KERNELS
    assert top.make_accumulate_op().engine is cb.KERNELS


# ---------------------------------------------------------------------------
# cross sections, config 1, the limb forward
# ---------------------------------------------------------------------------


def _config1():
    ll = co2_15um_band(j_max=30)
    jdl = jstage(ll, [(2, 1)], dtype=jnp.float64)
    return ll, jdl, interop.device_lines_from_numpy(_numpy(jdl), device=CPU)


@pytest.mark.parametrize("analytic_jvp", [True, "rev", False])
def test_cross_sections_match_jax_and_oracle(analytic_jvp):
    """Both cross sections against the reference's (each AD route) and the
    absorption against the golden oracle within tests/test_opacity.py's
    Weideman budget, on 1001 points of its band."""
    ll, jdl, dl = _config1()
    nu = np.linspace(640.0, 700.0, 1001)
    T, p = 220.0, 400.0
    ref = jop.cross_sections(jnp.asarray(nu), jdl, T, p, 0.3 * p,
                             variant=W, analytic_jvp=analytic_jvp)
    f = lambda a: torch.tensor(a, dtype=torch.float64)
    got = top.cross_sections(_t(nu), dl, f(T), f(p), f(0.3 * p), variant=W,
                             analytic_jvp=analytic_jvp)
    for g, r in zip(got, ref):
        _close(g, r)
    q = np.full(len(ll), tips.q_of_T(2, 1, 296.0) / tips.q_of_T(2, 1, T))
    oracle = numpy_ref.cross_section(nu, ll, T, p, 0.3 * p, q, cutoff=25.0)
    for g, o in zip(got, oracle):
        np.testing.assert_allclose(g.numpy(), o, rtol=5e-4,
                                   atol=o.max() * 1e-9)


def test_config1_matches_oracle_and_jax():
    """Acceptance config 1 through Weideman (the reference's golden test:
    rtol 5e-4 against the oracle), against the reference within TOL, and
    its Jacobian over the five scalars against jax.jacfwd."""
    ll, jdl, dl = _config1()
    nu = np.linspace(630.0, 705.0, 3001)
    sc = (215.0, 500.0, 2.0e27, 0.95, 260.0)
    q = np.full(len(ll), tips.q_of_T(2, 1, 296.0) / tips.q_of_T(2, 1, 215.0))
    golden = numpy_ref.nadir_single_layer(nu, ll, *sc, q, cutoff=25.0)
    ref = j_nadir(jnp.asarray(nu), jdl, *sc, variant=W)
    x = [torch.tensor(v, dtype=torch.float64) for v in sc]
    got = nadir_single_layer(_t(nu), dl, *x, variant=W)
    np.testing.assert_allclose(got.numpy(), golden, rtol=5e-4)
    _close(got, ref)
    J_ref = jax.jacfwd(lambda *a: j_nadir(jnp.asarray(nu), jdl, *a,
                                          variant=W),
                       argnums=(0, 1, 3, 4))(*sc)
    J = torch.func.jacfwd(lambda T, p, v, Ts: nadir_single_layer(
        _t(nu), dl, T, p, x[2], v, Ts, variant=W),
        argnums=(0, 1, 2, 3))(x[0], x[1], x[3], x[4])
    for g, r in zip(J, J_ref):
        _close(g, r)


@pytest.fixture(scope="module")
def limb():
    """An 8-level Mars limb scene (2 rays, 160 points, 9 ILS channels),
    the T + ln VMR(CO2) state."""
    atm = mars_standard_atmosphere(n_lev=8, z_top=70e3)
    d = {k: np.asarray(getattr(atm, k)) for k in ("z", "p", "T", "n")}
    d["vmr"] = {k: np.asarray(v) for k, v in atm.vmr.items()}
    tatm = interop.atmosphere_from_numpy(d, device=CPU)
    jdl = jstage(co2_15um_band(j_max=10), [(2, 1)], dtype=jnp.float64)
    dl = interop.device_lines_from_numpy(_numpy(jdl), device=CPU)
    from spectrobot_tpu.ops.ils import ils_matrix
    nu = np.linspace(660.0, 675.0, 160)
    Wm = ils_matrix(nu, np.linspace(662.0, 673.0, 9), 0.8)
    ths = np.array([8e3, 35e3])
    nu_off = nu - float(jdl.nu_ref)
    jf = jstate.build_forward(atm, jdl, jnp.asarray(nu), ["CO2"], J_MARS,
                              tangent_heights_m=jnp.asarray(ths),
                              ils_W=jnp.asarray(Wm), n_sub=2, variant=W,
                              nu_off=jnp.asarray(nu_off))
    jfr = jstate.build_forward(atm, jdl, jnp.asarray(nu), ["CO2"], J_MARS,
                               tangent_heights_m=jnp.asarray(ths),
                               ils_W=jnp.asarray(Wm), n_sub=2, variant=W,
                               nu_off=jnp.asarray(nu_off),
                               analytic_jvp="rev")
    kw = dict(tangent_heights_m=_t(ths), ils_W=_t(Wm), n_sub=2,
              nu_off=_t(nu_off), engine=cb.WEIDEMAN)
    tf = tstate.build_forward(tatm, dl, _t(nu), ["CO2"], MARS, **kw)
    tfr = tstate.build_forward(tatm, dl, _t(nu), ["CO2"], MARS,
                               analytic_jvp="rev", **kw)
    jx, jun = jstate.flatten_state(jstate.make_state(atm, ["CO2"]))
    tx, tun = tstate.flatten_state(tstate.make_state(tatm, ["CO2"]))
    return {"jf": jax.jit(lambda x: jf(jun(x))),
            "jfr": lambda x: jfr(jun(x)),
            "tf": lambda x: tf(tun(x)), "tfr": lambda x: tfr(tun(x)),
            "jx": jx, "tx": tx, "jatm": atm, "jdl": jdl, "dl": dl,
            "atm": tatm, "nu": nu}


def test_limb_forward_and_jacobian_match_jax(limb):
    """The forward (9 channels x 2 rays) and its 16-column jacfwd
    Jacobian through the WEIDEMAN engine (one accumulate and one contract
    call) against the reference's build_forward(variant='weideman')."""
    y_ref = limb["jf"](limb["jx"])
    _close(limb["tf"](limb["tx"]), y_ref)
    K_ref = jax.jit(jax.jacfwd(limb["jf"]))(limb["jx"])
    _close(torch.func.jacfwd(limb["tf"])(limb["tx"]), K_ref)


def test_limb_reverse_gradient_matches_jax(limb):
    """The gradient of a chi-square-like cost in mode 'rev' against the
    reference's, and against J^T dL/dy from the jacfwd Jacobian."""
    rng = np.random.default_rng(5)
    y0 = np.asarray(limb["jf"](limb["jx"]))
    y_obs = y0 * (1.0 + 0.02 * rng.standard_normal(y0.shape))
    sig = 0.01 * np.abs(y0).max()
    g_ref = jax.jit(jax.grad(lambda x: 0.5 * jnp.sum(
        ((limb["jfr"](x) - y_obs) / sig) ** 2)))(limb["jx"])
    x = limb["tx"].clone().requires_grad_()
    g = torch.autograd.grad(0.5 * torch.sum(
        ((limb["tfr"](x) - _t(y_obs)) / sig) ** 2), x)[0]
    _close(g, g_ref)
    K = torch.func.jacfwd(limb["tf"])(limb["tx"])
    g_jac = K.T @ ((limb["tf"](limb["tx"]) - _t(y_obs)) / sig ** 2)
    _close(g, g_jac.numpy(), tol=1e-9)


def test_limb_radiance_reverse_matches_plain_ad(limb):
    """tests/test_analytic_jvp.py's end-to-end case on the port: the
    gradient of sum(I^2) through limb_radiance in mode 'rev' (the WEIDEMAN
    engine) against plain autograd with the Weideman evaluator, and the
    reference's."""
    jatm, jdl, dl, atm = limb["jatm"], limb["jdl"], limb["dl"], limb["atm"]
    from spectrobot_tpu_torch.forward.geometry import limb_path_cg
    nu = np.linspace(662.0, 672.0, 128)
    ths = np.array([20e3, 40e3])

    def jloss(T):
        cg = j_limb_cg(jatm.with_temperature(T), ["CO2"], jnp.asarray(ths),
                       J_MARS, 2)
        return jnp.sum(j_limb_radiance(jnp.asarray(nu), jdl, cg,
                                       analytic_jvp="rev", variant=W) ** 2)

    def loss(T, mode):
        cg = limb_path_cg(atm.with_temperature(T), ["CO2"], _t(ths), MARS, 2)
        return torch.sum(limb_radiance(_t(nu), dl, cg, analytic_jvp=mode,
                                       engine=cb.WEIDEMAN) ** 2)

    g_ref = jax.jit(jax.grad(jloss))(jatm.T)
    g = {}
    for mode in ("rev", False):
        T = atm.T.clone().requires_grad_()
        g[mode] = torch.autograd.grad(loss(T, mode), T)[0]
    _close(g["rev"], g_ref)
    np.testing.assert_allclose(g["rev"].numpy(), g[False].numpy(), rtol=2e-5,
                               atol=float(g[False].abs().max()) * 1e-7)


# ---------------------------------------------------------------------------
# the table builds
# ---------------------------------------------------------------------------

LATTICE = dict(T_min=120.0, T_max=300.0, n_T=4, p_min=1e-2, p_max=1.2e3,
               n_p=5, chunk=128)


def test_lte_table_build_matches_jax(limb):
    """The LTE table built with variant='weideman' (the WEIDEMAN engine by
    default) at every node against the reference's build through
    accumulate_jnp, and unequal to the humlicek4 table."""
    nu = np.linspace(660.0, 675.0, 160)
    ref = jlut.build_lut(jnp.asarray(nu), limb["jdl"], 1, vmr_self=[0.95],
                         variant=W, **LATTICE)
    got = tlut.build_lut(_t(nu), limb["dl"], 1, vmr_self=[0.95], variant=W,
                         **LATTICE)
    _close(got.sigma, ref.sigma)
    h = tlut.build_lut(_t(nu), limb["dl"], 1, vmr_self=[0.95], **LATTICE)
    assert float((h.sigma - got.sigma).abs().max()) > \
        1e-8 * float(got.sigma.abs().max())


def test_nlte_table_build_matches_jax():
    """The non-LTE per-group tables (A_l, A_u, M) of the 4.3 um fundamental
    and hot band, matched to their levels, with variant='weideman'."""
    from spectrobot_tpu.data import nlte as j_nlte
    from spectrobot_tpu.data.synth import co2_43um_band, co2_43um_hot_band
    ll = co2_43um_band(j_max=10).concat(co2_43um_hot_band(j_max=6))
    ll = j_nlte.match_lines_to_levels(ll, j_nlte.registry_from_linelist(ll))
    jdl = jstage(ll, [(2, 1)], dtype=jnp.float64)
    dl = interop.device_lines_from_numpy(_numpy(jdl), device=CPU)
    nu = np.linspace(2320.0, 2360.0, 160)
    lat = dict(LATTICE, T_min=110.0, T_max=260.0, p_min=1e-3)
    ref = jlut.build_nlte_lut(jnp.asarray(nu), jdl, 1, vmr_self=[0.95],
                              variant=W, **lat)
    got = tlut.build_nlte_lut(_t(nu), dl, 1, vmr_self=[0.95], variant=W,
                              **lat)
    for f in ("sigma_l", "sigma_u", "sigma_e"):
        _close(getattr(got, f), getattr(ref, f))


def test_fingerprint_keeps_the_variants_apart(limb, tmp_path):
    """A humlicek4 table on disk is never loaded for a Weideman run: the
    variant is part of the fingerprint, so the second call builds anew
    (and rewrites the file), and a third Weideman call hits the cache."""
    nu = _t(np.linspace(660.0, 675.0, 96))
    path = str(tmp_path / "lut.npz")
    kw = dict(LATTICE, vmr_self=[0.95])
    fp = {v: tlut.lut_fingerprint(nu, limb["dl"], nlte=False, variant=v,
                                  **kw) for v in ("humlicek4", W)}
    assert fp["humlicek4"] != fp[W]
    h, cached = tlut.get_or_build_lut(path, nu, limb["dl"], 1,
                                      variant="humlicek4", **kw)
    assert not cached and tlut.stored_fingerprint(path) == fp["humlicek4"]
    w, cached = tlut.get_or_build_lut(path, nu, limb["dl"], 1, variant=W,
                                      **kw)
    assert not cached and tlut.stored_fingerprint(path) == fp[W]
    assert not torch.equal(w.sigma, h.sigma)
    again, cached = tlut.get_or_build_lut(path, nu, limb["dl"], 1, variant=W,
                                          **kw)
    assert cached and torch.equal(again.sigma, w.sigma)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

MESH_TOML = """\
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 256
[scene]
n_levels = 7
z_top_m = 60e3
[geometry]
tangent_heights_km = [8.0, 25.0]
n_sub = 2
[instrument]
enabled = true
fwhm_cm1 = 0.4
n_channels = 32
[compute]
chunk = 128
variant = "weideman"
dtype = "float64"
cutoff_cm1 = 5.0
mesh_nu = 2
mesh_halo = true
"""


def test_nu_halo_mesh_matches_jax(tmp_path):
    """The nu-halo tier on a (1, 1, 2) mesh of gloo ranks with
    compute.variant = "weideman": the forward and the temperature
    Jacobian through the WEIDEMAN engine (the ring-shifted halo lines
    too) against the reference's single-device build_forward."""
    from spectrobot_tpu.cli import build_scene as j_build_scene
    from spectrobot_tpu.config import load_config as j_load_config

    toml = tmp_path / "mesh.toml"
    toml.write_text(MESH_TOML)
    got = cases.run(tmp_path / "ranks", 2, cases.weideman_halo_case,
                    str(toml))
    planet, atm, dl, species, nu, nu_off, Wm, _, _, _ = j_build_scene(
        j_load_config(str(toml)))
    jf = jstate.build_forward(atm, dl, nu, species, planet,
                              tangent_heights_m=jnp.asarray([8e3, 25e3]),
                              ils_W=Wm, n_sub=2, variant=W, cutoff_cm1=5.0,
                              nu_off=nu_off)
    x, un = jstate.flatten_state(jstate.make_state(atm, []))
    y_ref = jax.jit(lambda v: jf(un(v)))(x)
    K_ref = jax.jit(jax.jacfwd(lambda v: jf(un(v))))(x)
    for y, K, name in got:
        assert name == "weideman"
        _close(y, y_ref)
        _close(K, K_ref)
