"""Reverse mode end to end in the PyTorch port: the gradient of sum(I^2)
through the port's limb and nadir forwards (analytic_jvp='rev') against the
JAX reference's and against the port's plain autograd, the gradient of a
retrieval cost against J^T r from the forward-mode Jacobian, the adjoint
tool on the CPU, and the memory of plain autograd with and without
recomputing its line slabs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.forward import geometry as jgeo
from spectrobot_tpu.forward import limb as jlimb
from spectrobot_tpu.ops.ils import ils_matrix
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu_torch import adjoint, interop
from spectrobot_tpu_torch.data.atmosphere import MARS
from spectrobot_tpu_torch.forward import geometry as tgeo
from spectrobot_tpu_torch.forward import limb as tlimb
from spectrobot_tpu_torch.retrieval import state as tstate

CPU = torch.device("cpu")
# These tests run tiny tensors: torch's intra-op threads would only
# contend (and spin-wait) with the other test workers for the cores.
torch.set_num_threads(1)


def _scene():
    """An 8-level Mars atmosphere and the CO2 band (j_max 16) in both
    packages, float64, on 160 points over 620-680 cm-1."""
    atm = mars_standard_atmosphere(n_lev=8, z_top=80e3)
    atm = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), atm)
    dl = j_stage(co2_15um_band(j_max=16), [(2, 1)], dtype=jnp.float64)
    tatm = interop.atmosphere_from_numpy(
        {**{k: np.asarray(getattr(atm, k)) for k in ("z", "p", "T", "n")},
         "vmr": {k: np.asarray(v) for k, v in atm.vmr.items()}}, device=CPU)
    tl = interop.device_lines_from_numpy(
        {k: np.asarray(v) for k, v in dl._asdict().items()}, device=CPU)
    nu64 = np.linspace(620.0, 680.0, 160)
    return atm, dl, tatm, tl, nu64


@pytest.mark.parametrize("geometry", ["limb", "nadir"])
def test_radiance_gradient_matches_jax_and_plain_ad(geometry):
    """d sum(I^2) / dT through limb_radiance / nadir_radiance with
    analytic_jvp='rev' against the reference's (engine 'jnp', its jnp
    transpose) and against the port's plain autograd (the reference's
    budget, tests/test_analytic_jvp.py:173)."""
    atm, dl, tatm, tl, nu64 = _scene()
    off = nu64 - float(dl.nu_ref)
    rays = np.array([15e3, 40e3]) if geometry == "limb" else \
        np.array([1.0, 1.7])

    def j_loss(T):
        a = atm.with_temperature(T)
        kw = dict(analytic_jvp="rev", nu_off=jnp.asarray(off))
        if geometry == "limb":
            cg = jgeo.limb_path_cg(a, ["CO2"], jnp.asarray(rays), J_MARS, 2)
            I = jlimb.limb_radiance(jnp.asarray(nu64), dl, cg, **kw)
        else:
            cg = jgeo.nadir_path_cg(a, ["CO2"], jnp.asarray(rays), 2)
            I = jlimb.nadir_radiance(jnp.asarray(nu64), dl, cg, 215.0,
                                     emissivity=0.9, **kw)
        return jnp.sum(I ** 2)

    def t_grad(mode):
        T = tatm.T.detach().clone().requires_grad_()
        a = tatm.with_temperature(T)
        kw = dict(analytic_jvp=mode, nu_off=torch.as_tensor(off))
        nu = torch.as_tensor(nu64)
        if geometry == "limb":
            cg = tgeo.limb_path_cg(a, ["CO2"], torch.as_tensor(rays), MARS, 2)
            I = tlimb.limb_radiance(nu, tl, cg, **kw)
        else:
            cg = tgeo.nadir_path_cg(a, ["CO2"], torch.as_tensor(rays), 2)
            I = tlimb.nadir_radiance(nu, tl, cg, 215.0, emissivity=0.9, **kw)
        return torch.autograd.grad(torch.sum(I ** 2), T)[0].numpy()

    g_ref = np.asarray(jax.grad(j_loss)(atm.T))
    g_rev, g_ad = t_grad("rev"), t_grad(False)
    assert np.isfinite(g_rev).all() and np.abs(g_rev).max() > 0
    for got, ref in ((g_rev, g_ref), (g_rev, g_ad)):
        np.testing.assert_allclose(got, ref, rtol=2e-5,
                                   atol=1e-7 * np.abs(ref).max())


def test_retrieval_cost_gradient_equals_JTr():
    """The gradient of 1/2 |(y - y_obs) / sigma|^2 with respect to the flat
    state (T and ln VMR(CO2), 3 rays, 23 ILS channels) through
    build_forward(analytic_jvp='rev') equals J^T (r / sigma^2) with J from
    jacfwd through build_forward(analytic_jvp=True), float64."""
    _, _, tatm, tl, _ = _scene()
    nu64 = np.linspace(660.0, 675.0, 301)
    W = torch.as_tensor(ils_matrix(nu64, np.linspace(662, 673, 23), 0.7))
    fwd = {mode: tstate.build_forward(
        tatm, tl, torch.as_tensor(nu64), ["CO2"], MARS,
        tangent_heights_m=torch.as_tensor([8e3, 25e3, 45e3]), ils_W=W,
        n_sub=2, analytic_jvp=mode) for mode in (True, "rev")}
    x0, unravel = tstate.flatten_state(tstate.make_state(tatm, ["CO2"]))
    f = {m: (lambda x, F=F: F(unravel(x))) for m, F in fwd.items()}
    rng = np.random.default_rng(0)
    y0 = f[True](x0)
    sigma = torch.as_tensor(rng.uniform(0.5, 1.5, y0.shape[0])) * 0.01 * \
        float(y0.max())
    y_obs = y0 * torch.as_tensor(1.0 + 0.02 * rng.normal(size=y0.shape[0]))
    J = tstate.jacobian_fwd(f[True], x0)
    want = J.T @ ((y0 - y_obs) / sigma ** 2)
    x = x0.clone().requires_grad_()
    cost = 0.5 * torch.sum(((f["rev"](x) - y_obs) / sigma) ** 2)
    (got,) = torch.autograd.grad(cost, x)
    assert got.shape == (2 * tatm.n_lev,)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9,
                               atol=1e-12 * float(want.abs().max()))


def test_adjoint_tool_runs_on_cpu(capsys):
    res = adjoint.run(CPU, chunk=8, repeats=1, n_points=128, n_lev=6,
                      j_max=6, n_rays=2)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("lines=13  points=128") and "device=cpu" in out[0]
    assert out[1].startswith("analytic_rev") and out[2].startswith("plain_ad")
    assert "chunk 8 of the asked 8" in out[2]
    assert out[3].startswith("speedup:")
    assert res["legs"]["plain_ad"]["chunk"] == 8
    g = res["legs"]["analytic_rev"]["grad"]
    assert g.shape == (6,) and np.isfinite(g).all()
    # float32: the analytic and the plain-AD gradients agree to roundoff.
    assert res["max_rel_grad_diff"] < 1e-4


def test_plain_ad_remat_keeps_one_slab():
    """Plain autograd through the line sum keeps about 390 bytes per
    (state, line, point) for its backward pass; with remat it keeps only
    the slabs' inputs and recomputes them, for the same gradient."""
    from spectrobot_tpu_torch.ops.opacity import line_sum_plain_ad

    rng = np.random.default_rng(0)
    B, L, P = 4, 40, 512
    t = lambda a: torch.tensor(a, dtype=torch.float32, requires_grad=True)
    nu = torch.linspace(-30.0, 30.0, P)
    args = [t(np.sort(rng.uniform(-30, 30, (B, L)), axis=1)),
            t(rng.uniform(300.0, 1300.0, (B, L))),
            t(10.0 ** rng.uniform(-3.0, 1.0, (B, L))),
            t(rng.uniform(0.5, 1.5, (B, 2, L)))]
    grads, saved = [], []
    for remat in (False, True):
        storages = {}

        def pack(x):
            storages[x.untyped_storage().data_ptr()] = \
                x.untyped_storage().nbytes()
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            out = line_sum_plain_ad(nu, *args, chunk=10, remat=remat)
        saved.append(sum(storages.values()) / (B * L * P))
        grads.append(torch.autograd.grad(out.sum(), args))
    assert 300 < saved[0] < 500 and saved[1] < 0.05 * saved[0], saved
    for a, b in zip(*grads):
        assert torch.equal(a, b)
