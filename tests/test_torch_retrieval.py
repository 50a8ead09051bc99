"""The retrieval slice of the PyTorch port against the JAX reference: the
state vector's flat order, the node basis, the Levenberg-Marquardt loop
(same iterations, stop reason, state and chi^2 in float64) and checkpoint
resume."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.ops.ils import ils_matrix
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu.retrieval import oe as joe
from spectrobot_tpu.retrieval import state as jstate
from spectrobot_tpu.utils.checkpoint import Checkpointer
from spectrobot_tpu_torch import interop
from spectrobot_tpu_torch.data.atmosphere import MARS
from spectrobot_tpu_torch.ops import cuda_basis as cb
from spectrobot_tpu_torch.retrieval import oe as toe
from spectrobot_tpu_torch.retrieval import state as tstate

CPU = torch.device("cpu")
# These tests run tiny tensors: torch's intra-op threads would only
# contend (and spin-wait) with the other test workers for the cores.
torch.set_num_threads(1)


def _atm_pair(n_lev=8, z_top=70e3):
    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=z_top)
    tatm = interop.atmosphere_from_numpy(
        {**{k: np.asarray(getattr(atm, k)) for k in ("z", "p", "T", "n")},
         "vmr": {k: np.asarray(v) for k, v in atm.vmr.items()}}, device=CPU)
    return atm, tatm


def test_flat_state_order_matches_ravel_pytree():
    """T, then T_surface, then ln_vmr by sorted species: one flat vector
    means the same state in both packages."""
    atm, tatm = _atm_pair()
    species = [s for s in ("H2O", "CO2", "CO") if s in atm.vmr]
    assert len(species) >= 2
    js = jstate.make_state(atm, species, T_surface=210.0)
    ts = tstate.make_state(tatm, species, T_surface=210.0)
    jx, _ = jstate.flatten_state(js)
    tx, unravel = tstate.flatten_state(ts)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-15)
    back = unravel(tx)
    assert float(back["T_surface"]) == 210.0
    for s in species:
        torch.testing.assert_close(back["ln_vmr"][s], ts["ln_vmr"][s])
    # The reference's flat vector, carried into the port's structure.
    xs = np.asarray(jx) * 1.01
    st = interop.state_from_numpy(xs, ts)
    np.testing.assert_allclose(tstate.flatten_state(st)[0].numpy(), xs)
    with pytest.raises(ValueError, match="shape"):
        interop.state_from_numpy(xs[:-1], ts)


def test_node_basis_matches_jax():
    atm, tatm = _atm_pair(n_lev=12)
    jnb = jstate.NodeBasis.uniform(atm, 5)
    tnb = tstate.NodeBasis.uniform(tatm, 5)
    np.testing.assert_allclose(tnb.M, np.asarray(jnb.M), rtol=1e-15)
    z_nodes = np.array([0.0, 7e3, 21e3, 45e3, 70e3])
    np.testing.assert_allclose(
        tstate.node_level_matrix(np.asarray(atm.z), z_nodes),
        np.asarray(jstate.node_level_matrix(np.asarray(atm.z), z_nodes)),
        rtol=1e-15)
    js = jnb.init_state(atm, ["CO2"])
    ts = tnb.init_state(tatm, ["CO2"])
    np.testing.assert_allclose(tstate.flatten_state(ts)[0].numpy(),
                               np.asarray(jstate.flatten_state(js)[0]),
                               rtol=1e-14)
    je, te = jnb.expand(js), tnb.expand(ts)
    np.testing.assert_allclose(te["T"].numpy(), np.asarray(je["T"]),
                               rtol=1e-14)
    nb = interop.node_basis_from_numpy(np.asarray(jnb.M), jnb.z_lev,
                                       jnb.z_nodes)
    np.testing.assert_array_equal(nb.M, np.asarray(jnb.M))


def test_lm_algebra_matches_jax():
    rng = np.random.default_rng(2)
    n_x, n_y = 7, 40
    K = rng.normal(size=(n_y, n_x))
    F, y = rng.normal(size=n_y), rng.normal(size=n_y)
    x, x_a = rng.normal(size=n_x), rng.normal(size=n_x)
    w = rng.uniform(0.5, 2.0, n_y)
    Sai = np.diag(rng.uniform(0.1, 1.0, n_x))
    for lam in (0.0, 0.3):
        ref = joe._lm_step(x, K, F, y, x_a, w, Sai, lam)
        got = toe._lm_step(torch.as_tensor(x), torch.as_tensor(K),
                           torch.as_tensor(F), y, x_a, w, Sai, lam)
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g, r, rtol=1e-12)
        H, g_ = (K.T * w) @ K, (K.T * w) @ (y - F)
        for r, g in zip(joe._lm_solve(x, H, g_, x_a, Sai, lam),
                        toe._lm_solve(x, H, g_, x_a, Sai, lam)):
            np.testing.assert_allclose(g, r, rtol=1e-12)
    np.testing.assert_allclose(
        toe._chi2_terms(y, torch.as_tensor(F), x, x_a, w, Sai),
        joe._chi2_terms(y, F, x, x_a, w, Sai), rtol=1e-14)


@pytest.fixture(scope="module")
def problem():
    """A T + ln VMR(CO2) retrieval on 4 altitude nodes of an 8-level limb
    scene (3 rays, 23 ILS channels), float64, with observations from the
    reference's forward at a perturbed truth plus numpy noise."""
    atm, tatm = _atm_pair()
    dl = j_stage(co2_15um_band(j_max=10), [(2, 1)], dtype=jnp.float64)
    tl = interop.device_lines_from_numpy(
        {k: np.asarray(v) for k, v in dl._asdict().items()}, device=CPU)
    nu64 = np.linspace(660.0, 675.0, 301)
    W = ils_matrix(nu64, np.linspace(662, 673, 23), 0.7)
    ths = np.array([8e3, 25e3, 45e3])
    nu_off = nu64 - float(dl.nu_ref)
    jnb = jstate.NodeBasis.uniform(atm, 4)
    tnb = interop.node_basis_from_numpy(jnb.M, jnb.z_lev, jnb.z_nodes)

    jf = jstate.build_forward(
        atm, dl, jnp.asarray(nu64), ["CO2"], J_MARS,
        tangent_heights_m=jnp.asarray(ths), ils_W=jnp.asarray(W), n_sub=2,
        nu_off=jnp.asarray(nu_off), engine="jnp")
    tf = tstate.build_forward(
        tatm, tl, torch.as_tensor(nu64), ["CO2"], MARS,
        tangent_heights_m=torch.as_tensor(ths), ils_W=torch.as_tensor(W),
        n_sub=2, nu_off=torch.as_tensor(nu_off), engine=cb.PLAIN)
    jx0, junravel = jstate.flatten_state(jnb.init_state(atm, ["CO2"]))
    tx0, tunravel = tstate.flatten_state(tnb.init_state(tatm, ["CO2"]))
    jfwd = jax.jit(lambda x: jf(jnb.expand(junravel(x))))
    jjac = jax.jit(jax.jacfwd(jfwd))
    tfwd = lambda x: tf(tnb.expand(tunravel(x)))

    truth = np.asarray(jx0) + np.concatenate(
        [[4.0, -3.0, 5.0, 2.0], [0.1, -0.15, 0.2, 0.1]])
    y_clean = np.asarray(jfwd(jnp.asarray(truth)))
    sigma = np.full_like(y_clean, 0.005 * y_clean.max())
    y = y_clean + np.random.default_rng(5).normal(size=y_clean.shape) * sigma
    S_a = np.diag([10.0 ** 2] * 4 + [0.5 ** 2] * 4)
    return dict(jfwd=jfwd, jjac=jjac, jx0=jx0, tfwd=tfwd, tx0=tx0, y=y,
                sigma=sigma, S_a=S_a)


def _torch_retrieve(p, cfg, checkpointer=None):
    return toe.retrieve(p["tfwd"], torch.func.jacfwd(p["tfwd"]), p["y"],
                        p["tx0"], p["tx0"], p["S_a"], p["sigma"], cfg,
                        checkpointer=checkpointer)


def test_retrieve_matches_jax_f64(problem):
    p = problem
    cfg = joe.OEConfig(max_iter=12)
    ref = joe.retrieve(p["jfwd"], p["jjac"], jnp.asarray(p["y"]), p["jx0"],
                       p["jx0"], p["S_a"], jnp.asarray(p["sigma"]), cfg)
    got = _torch_retrieve(p, toe.OEConfig(max_iter=12))
    assert ref.converged and ref.n_iter >= 2
    assert (got.n_iter, got.converged, got.stop_reason) == (
        ref.n_iter, ref.converged, ref.stop_reason)
    np.testing.assert_allclose(got.x, np.asarray(ref.x), rtol=1e-6)
    np.testing.assert_allclose(got.chi2, ref.chi2, rtol=1e-6)
    np.testing.assert_allclose(got.chi2_meas, ref.chi2_meas, rtol=1e-6)
    np.testing.assert_allclose(got.S_hat, ref.S_hat, rtol=1e-5)
    np.testing.assert_allclose(got.dof, ref.dof, rtol=1e-6)
    assert [h["accepted"] for h in got.history] == [
        h["accepted"] for h in ref.history]


def test_checkpoint_resume(problem, tmp_path):
    """A run stopped after one iteration resumes from its checkpoint at the
    next one and ends where an uninterrupted run ends."""
    p = problem
    full = _torch_retrieve(p, toe.OEConfig(max_iter=12))
    ck = Checkpointer(str(tmp_path / "ck"))
    first = _torch_retrieve(p, toe.OEConfig(max_iter=1), ck)
    assert first.n_iter == 1 and ck.latest()["iteration"] == 0
    resumed = _torch_retrieve(p, toe.OEConfig(max_iter=12), ck)
    assert (resumed.n_iter, resumed.converged, resumed.stop_reason) == (
        full.n_iter, full.converged, full.stop_reason)
    assert len(resumed.history) == len(full.history)
    np.testing.assert_allclose(resumed.x, full.x, rtol=1e-10)
    # A checkpoint of another state size is refused, not silently reused.
    with pytest.raises(ValueError, match="state parameters"):
        toe.retrieve(p["tfwd"], None, p["y"], p["tx0"][:-1], p["tx0"][:-1],
                     p["S_a"][:-1, :-1], p["sigma"], toe.OEConfig(),
                     checkpointer=ck)
