"""The engine rule's two humlicek4 configurations beyond float32 kernels,
against the JAX reference under x64 on the CPU:

- float64 through the float32 kernels: an engine over the plain versions
  that computes in float32 (``ops.opacity.with_compute_dtype``, the cast
  ``ops.cuda_basis.KERNELS`` makes on the card) on float64 inputs, against
  the reference's ``make_accumulate_op(engine='pallas', interpret=True)``
  (its float32 kernels inside a float64 pipeline): the primal, ``jvp``,
  ``jacfwd`` and the reverse-mode gradient, one state and a batch of
  states; ``cross_sections`` against ``accumulate_pallas_jit``; a small
  ``build_forward`` and its Jacobian against the reference's
  ``build_forward(engine='pallas', interpret=True)``.  Outputs, tangents
  and cotangents are float64, held to the kernels' float32 budgets;
- ``compute.use_pallas = false`` (``ops.cuda_basis.PLAIN``) against the
  reference's XLA engine (``engine='jnp'``) in both dtypes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band, random_lines
from spectrobot_tpu.ops import opacity as jop
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu.retrieval import state as jstate
from spectrobot_tpu_torch import interop
from spectrobot_tpu_torch.data.atmosphere import MARS
from spectrobot_tpu_torch.ops import cuda_basis as cb
from spectrobot_tpu_torch.ops import opacity as top
from spectrobot_tpu_torch.retrieval import state as tstate

CPU = torch.device("cpu")
# These tests run tiny tensors: torch's intra-op threads would only
# contend (and spin-wait) with the other test workers for the cores.
torch.set_num_threads(1)

# The kernels' float32 budgets: a sum within RTOL |ref| + ATOL_REL max|ref|
# (tests/test_pallas_opacity.py:90), a tangent, Jacobian or gradient within
# DERIV_REL max|ref| (tests/test_pallas_jacobian.py:124,182).  PLAIN in
# float64 against the reference's XLA engine: F64_REL max|ref|.
RTOL, ATOL_REL, DERIV_REL, F64_REL = 3e-5, 1e-6, 1e-5, 1e-10

# The engine the card's KERNELS is, over the plain versions on the CPU:
# float32 primitives, a float64 pipeline's tensors cast there and back.
CAST = top.with_compute_dtype(dataclasses.replace(cb.PLAIN, name="cast"),
                              torch.float32, ("cpu",))


def _sum_ok(got, ref) -> bool:
    scale = np.abs(ref).max()
    return bool(np.all(np.abs(got - ref) <= RTOL * np.abs(ref)
                       + ATOL_REL * scale))


def _deriv_ok(got, ref, rel=DERIV_REL) -> bool:
    return bool(np.max(np.abs(got - ref)) <= rel * np.abs(ref).max())


@pytest.fixture(scope="module")
def lines():
    """120 random lines over 600-640 cm-1 at 220 K and 500 Pa, two
    amplitude rows, on 300 points in offset coordinates, float64; and three
    states of them for the batched op."""
    L, P = 120, 300
    dl = j_stage(random_lines(L, 600.0, 640.0, seed=7), [(2, 1)],
                 dtype=jnp.float64)
    w = np.stack([np.ones(L), np.linspace(0.5, 1.5, L)])
    kl = jop.line_kernel_inputs(dl, 220.0, 500.0, 50.0,
                                amp_weights=jnp.asarray(w))
    nu = np.linspace(605.0, 635.0, P) - float(dl.nu_ref)
    one = {k: np.array(getattr(kl, k)) for k in
           ("nu_c", "scale_x", "y", "amps")}
    batch = {k: np.stack([v * (1 + 0.02 * b) if k != "nu_c" else v + 0.01 * b
                          for b in range(3)]) for k, v in one.items()}
    return nu, np.array(dl.nu0), one, batch


def _theta(args):
    """f(op)(theta): the line inputs moved by four scalars (a center shift
    and relative changes of sx, y and the amplitudes), a 4-column
    Jacobian."""
    nu, nc, sx, y, amps = args
    return lambda op: lambda th: op(nu, nc + th[0], sx * (1 + th[1]),
                                    y * (1 + th[2]), amps * (1 + th[3]))


def _ops(mode, engine, nu0, batched):
    """(the reference's op, the port's op on ``engine``): the reference's
    float32 Pallas kernels (interpret mode) against ``CAST``, its XLA
    engine against ``PLAIN``."""
    ref = jop.make_accumulate_op(
        engine="jnp" if engine is cb.PLAIN else "pallas", mode=mode,
        cutoff_cm1=25.0, interpret=True)
    if batched:
        return (jax.vmap(ref, in_axes=(None, 0, 0, 0, 0)),
                top.LineSumOp(engine, None, 25.0, mode,
                              torch.as_tensor(nu0)))
    return ref, top.make_accumulate_op(mode=mode, cutoff_cm1=25.0,
                                       engine=engine,
                                       centers=torch.as_tensor(nu0))


def _run(lines, dtype, engine, batched):
    """The primal, the 4-column jacfwd and the reverse-mode gradient of a
    weighted sum of the outputs, through the reference and the port in
    ``dtype``: {name: (port, reference)} as numpy arrays."""
    nu, nu0, one, batch = lines
    ins = batch if batched else one
    args = [np.asarray(a, dtype) for a in
            (nu, ins["nu_c"], ins["scale_x"], ins["y"], ins["amps"])]
    j_args = [jnp.asarray(a) for a in args]
    t_args = [torch.as_tensor(a) for a in args]
    out = {}
    ref_f, port_f = _ops("fwd", engine, nu0, batched)
    out["primal"] = (port_f(*t_args), ref_f(*j_args))
    th = np.zeros(4, dtype)
    out["jacfwd"] = (torch.func.jacfwd(_theta(t_args)(port_f))(
                         torch.as_tensor(th)),
                     jax.jacfwd(_theta(j_args)(ref_f))(jnp.asarray(th)))
    ref_r, port_r = _ops("rev", engine, nu0, batched)
    w = np.random.default_rng(3).normal(size=np.shape(out["primal"][1]))
    w = w.astype(dtype)
    t_in = [a.clone().requires_grad_() for a in t_args[1:]]
    g_port = torch.autograd.grad(
        torch.sum(port_r(t_args[0], *t_in) * torch.as_tensor(w)), t_in)
    g_ref = jax.grad(lambda *a: jnp.sum(ref_r(j_args[0], *a)
                                        * jnp.asarray(w)),
                     argnums=(0, 1, 2, 3))(*j_args[1:])
    for name, gp, gr in zip(("grad nu_c", "grad sx", "grad y", "grad amps"),
                            g_port, g_ref):
        out[name] = (gp, gr)
    return {k: (p.detach().numpy(), np.asarray(r)) for k, (p, r)
            in out.items()}


@pytest.mark.parametrize("batched", [False, True])
def test_cast_engine_matches_reference_kernels_under_x64(lines, batched):
    """float64 inputs through float32 primitives: the primal within the
    sum budget, the jacfwd columns and the gradient within DERIV_REL of
    the reference's float32 Pallas kernels under x64; everything float64,
    as the reference's ``astype(result_type(nu_grid))`` gives."""
    for name, (got, ref) in _run(lines, np.float64, CAST, batched).items():
        assert got.dtype == ref.dtype == np.float64, name
        assert got.shape == ref.shape, name
        ok = _sum_ok(got, ref) if name == "primal" else _deriv_ok(got, ref)
        assert ok, (name, np.max(np.abs(got - ref)), np.abs(ref).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_engine_matches_reference_xla_engine(lines, dtype):
    """``PLAIN`` (``compute.use_pallas = false`` on the card) against the
    reference's XLA engine: within F64_REL of max|ref| in float64, the
    float32 budgets in float32; the dtype is the caller's."""
    for name, (got, ref) in _run(lines, dtype, cb.PLAIN, False).items():
        assert got.dtype == ref.dtype == dtype, name
        if dtype == np.float64:
            ok = _deriv_ok(got, ref, F64_REL)
        else:
            ok = (_sum_ok(got, ref) if name == "primal"
                  else _deriv_ok(got, ref))
        assert ok, (name, np.max(np.abs(got - ref)), np.abs(ref).max())


def test_cross_sections_through_the_cast_match_reference_kernel():
    """``cross_sections`` of one float64 state through ``CAST`` against the
    reference's K3 (``accumulate_pallas_jit``, interpret mode) on the same
    float64 line inputs: float64, within the sum budget."""
    from spectrobot_tpu.ops.opacity import accumulate_pallas_jit
    dl = j_stage(co2_15um_band(j_max=10), [(2, 1)], dtype=jnp.float64)
    tl = interop.device_lines_from_numpy(
        {k: np.asarray(v) for k, v in dl._asdict().items()}, device=CPU)
    nu = np.linspace(640.0, 700.0, 512)
    T, p, ps = 220.0, 400.0, 120.0
    kl = jop.line_kernel_inputs(dl, T, p, ps, amp_weights=jnp.ones(
        (2, dl.nu0.shape[0])))
    ref = np.asarray(accumulate_pallas_jit(
        jnp.asarray(nu - float(dl.nu_ref)), kl, cutoff_cm1=25.0,
        interpret=True).astype(jnp.float64))
    got = top.cross_sections(torch.as_tensor(nu), tl, T, p, ps,
                             engine=CAST)
    for row, g in enumerate(got):
        assert g.dtype == torch.float64
        assert _sum_ok(g.numpy(), ref[row]), row


def test_build_forward_through_the_cast_matches_reference_kernels():
    """A small float64 limb forward and its jacfwd over the temperature
    profile, the line sum through ``CAST``, against the reference's
    ``build_forward(engine='pallas', interpret=True)`` under x64: float64,
    the radiances within the sum budget, the Jacobian within DERIV_REL."""
    atm = mars_standard_atmosphere(n_lev=5, z_top=60e3)
    dl = j_stage(co2_15um_band(j_max=8), [(2, 1)], dtype=jnp.float64)
    nu = np.linspace(640.0, 700.0, 256)
    ths = np.array([10e3, 35e3])
    nu_off = nu - float(dl.nu_ref)
    jf = jstate.build_forward(
        atm, dl, jnp.asarray(nu), ["CO2"], J_MARS,
        tangent_heights_m=jnp.asarray(ths), n_sub=2,
        nu_off=jnp.asarray(nu_off), engine="pallas", interpret=True)
    tatm = interop.atmosphere_from_numpy(
        {**{k: np.asarray(getattr(atm, k)) for k in ("z", "p", "T", "n")},
         "vmr": {k: np.asarray(v) for k, v in atm.vmr.items()}}, device=CPU)
    tl = interop.device_lines_from_numpy(
        {k: np.asarray(v) for k, v in dl._asdict().items()}, device=CPU)
    tf = tstate.build_forward(
        tatm, tl, torch.as_tensor(nu), ["CO2"], MARS,
        tangent_heights_m=torch.as_tensor(ths), n_sub=2,
        nu_off=torch.as_tensor(nu_off), engine=CAST)
    T0 = np.array(atm.T)
    j = lambda T: jf({"T": T, "ln_vmr": {}})
    t = lambda T: tf({"T": T, "ln_vmr": {}})
    I, I_ref = t(torch.as_tensor(T0)).numpy(), np.asarray(j(jnp.asarray(T0)))
    assert I.dtype == I_ref.dtype == np.float64
    assert _sum_ok(I, I_ref)
    J = torch.func.jacfwd(t)(torch.as_tensor(T0)).numpy()
    J_ref = np.asarray(jax.jacfwd(j)(jnp.asarray(T0)))
    assert J.dtype == np.float64 and J.shape == J_ref.shape
    assert _deriv_ok(J, J_ref), np.max(np.abs(J - J_ref))


def test_the_cast_is_the_engines():
    """Every floating tensor a cast engine's primitives get is float32,
    while the line sum's primal, its jacfwd and its gradient come back
    float64; float32 calls pass through untouched; KERNELS casts on CUDA
    only, so every CPU path keeps its dtype; an engine casts once."""
    seen = []

    def recorded(fn):
        def call(nu, windows, *args, **kw):
            seen.extend(a.dtype for a in (nu, *args, *kw.values())
                        if isinstance(a, torch.Tensor)
                        and a.is_floating_point())
            return fn(nu, windows, *args, **kw)
        return call

    rec = dataclasses.replace(cb.PLAIN, name="rec", **{
        f: recorded(getattr(cb.PLAIN, f)) for f in
        ("accumulate", "contract", "transpose", "accumulate_single",
         "contract_single")})
    eng = top.with_compute_dtype(rec, torch.float32, ("cpu",))
    rng = np.random.default_rng(0)
    L, P = 40, 64
    t = lambda *s: torch.as_tensor(rng.uniform(0.5, 1.5, s))
    nu = torch.linspace(-5.0, 5.0, P, dtype=torch.float64)
    nc, sx, y, amps = (t(2, L) * 3 - 4.5, t(2, L) * 30, t(2, L) * 0.1,
                       t(2, 2, L))
    for mode in ("fwd", "rev"):
        op = top.LineSumOp(eng, None, 25.0, mode)
        out = op(nu, nc, sx, y, amps)
        assert out.dtype == torch.float64
        if mode == "fwd":
            J = torch.func.jacfwd(lambda s: op(nu, nc + s, sx, y, amps))(
                torch.zeros((), dtype=torch.float64))
            assert J.dtype == torch.float64
        else:
            x = sx.clone().requires_grad_()
            g, = torch.autograd.grad(op(nu, nc, x, y, amps).sum(), x)
            assert g.dtype == torch.float64
    assert seen and set(seen) == {torch.float32}
    seen.clear()
    out32 = top.LineSumOp(eng, None, 25.0)(*(a.float() for a in
                                             (nu, nc, sx, y, amps)))
    assert out32.dtype == torch.float32 and set(seen) == {torch.float32}
    assert eng.describe(torch.float64, CPU) == \
        "rec (float32 primitives in a float64 pipeline)"
    assert eng.describe(torch.float32, CPU) == "rec"
    assert cb.KERNELS.dtype_on("cuda") == torch.float32
    assert cb.KERNELS.dtype_on(CPU) is None
    assert cb.PLAIN.dtype_on("cuda") is None
    with pytest.raises(ValueError, match="already computes in"):
        top.with_compute_dtype(cb.KERNELS, torch.float32)
