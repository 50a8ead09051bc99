"""The composed feature matrix of the port (tests/test_mesh_composed.py):
non-LTE x CIA x FOV x limb x the nu-halo tier through make_sharded_oe on a
(2, 2, 2) mesh of gloo ranks, retrieved to convergence, with forward and
Jacobian parity against the single-device path and the JAX package, in
float64.  The port's scene is its own copy of the host part of
``__graft_entry__._composed_scene`` (tests/torch_mesh_cases.py)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.retrieval.state import build_forward as j_build_forward
from spectrobot_tpu.retrieval.state import flatten_state as j_flatten
from spectrobot_tpu.retrieval.state import make_state as j_make_state
from spectrobot_tpu_torch.data.atmosphere import MARS
from spectrobot_tpu_torch.retrieval.oe import OEConfig, retrieve
from spectrobot_tpu_torch.retrieval.state import (
    build_forward, flatten_state, make_state)

import torch_mesh_cases as cases

torch.set_num_threads(1)

# Smaller than the reference's dryrun scene (the LM loop runs to
# convergence twice) but every feature present and every mesh axis > 1.
SCENE = dict(n_lev=8, n_nu=512, n_fine=4, j_max=8)
SHAPE = (2, 2, 2)
MAX_ITER = 8
# float64 parity: the port against the reference, and the mesh (sums in
# shard order) against one device, within TOL of max |ref|.
TOL = 1e-10


@pytest.fixture(scope="module")
def composed():
    """(the reference's scene, the port's), float64."""
    from __graft_entry__ import _composed_scene
    return (_composed_scene(**SCENE, dtype=jnp.float64),
            cases.composed_scene(**SCENE, dtype=torch.float64))


def _port_forward(t_scene, **over):
    atm, dl, nlte, cia, nu, h_fine, fov_V, _ = t_scene
    kw = dict(tangent_heights_m=h_fine, fov_V=fov_V, nlte=nlte, cia=cia,
              **cases.COMPOSED)
    kw.update(over)
    fwd = build_forward(atm, dl, nu, ["CO2"], MARS, **kw)
    x0, unravel = flatten_state(make_state(atm, []))
    return (lambda x: fwd(unravel(x))), x0


def _jax_forward(j_scene):
    atm, dl, nlte, cia, nu, h_fine, fov_V, _ = j_scene
    fwd = j_build_forward(atm, dl, nu, ["CO2"], J_MARS,
                          tangent_heights_m=h_fine, fov_V=fov_V, nlte=nlte,
                          cia=cia, n_sub=2, variant="humlicek4",
                          cutoff_cm1=8.0, chunk=128)
    x0, unravel = j_flatten(j_make_state(atm, []))
    return jax.jit(lambda x: fwd(unravel(x))), x0


@pytest.fixture(scope="module")
def single(composed):
    """The port's single-device forward, its y and K at the truth."""
    f, x0 = _port_forward(composed[1])
    return f, x0, f(x0).numpy(), torch.func.jacfwd(f)(x0).numpy()


@pytest.fixture(scope="module")
def ranks(composed, single, tmp_path_factory):
    """The (2, 2, 2) mesh: forward and Jacobian at the truth, and the LM
    retrieval of noisy observations from a biased start."""
    _, x_true, y_clean, _ = single
    sigma = np.full(y_clean.shape, 0.005 * y_clean.max())
    rng = np.random.default_rng(1)
    y_obs = y_clean + sigma * rng.standard_normal(y_clean.shape)
    n_lev = composed[1][0].n_lev
    x0 = x_true.numpy().copy()
    x0[:n_lev] += 4.0
    S_a = np.diag(np.full(n_lev, 10.0 ** 2))
    got = cases.run(tmp_path_factory.mktemp("composed"), 8,
                    cases.composed_case, SHAPE, SCENE, y_obs, sigma, x0, S_a,
                    MAX_ITER)
    return got, (y_obs, sigma, x0, S_a)


def test_composed_forward_and_jacobian_parity(composed, single, ranks):
    """The port's composed forward and Jacobian equal the reference's
    single-device ones; the (2, 2, 2) mesh's equal the port's single
    device on every rank."""
    j_scene, t_scene = composed
    for a, b in ((t_scene[3].tables, j_scene[3].tables),
                 (t_scene[6], j_scene[6]), (t_scene[2].t_vib,
                                             j_scene[2].t_vib)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13)
    f_ref, x_ref = _jax_forward(j_scene)
    y_ref = np.asarray(f_ref(x_ref))
    K_ref = np.asarray(jax.jit(jax.jacfwd(f_ref))(x_ref))
    _, _, y, K = single
    assert np.isfinite(y).all() and (y > 0).any() and np.isfinite(K).all()
    assert y.shape == (t_scene[7] * 512,)
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=TOL * y_ref.max())
    np.testing.assert_allclose(K, K_ref, rtol=0,
                               atol=TOL * np.abs(K_ref).max())
    got, _ = ranks
    for r, out in enumerate(got):
        # FOV mixes ray and there is no ILS: rows are sharded over nu only.
        assert out["row_axes"] == ("nu",), r
        np.testing.assert_allclose(out["y"].numpy(), y, rtol=0,
                                   atol=TOL * y.max(), err_msg=f"rank {r}")
        np.testing.assert_allclose(out["K"].numpy(), K, rtol=0,
                                   atol=TOL * np.abs(K).max(),
                                   err_msg=f"rank {r}")


def test_composed_features_are_live(composed, single):
    """Each composed feature visibly changes the spectrum (a composition
    that silently dropped one must fail)."""
    t_scene = composed[1]
    _, x0, base, _ = single

    def y(**over):
        f, _ = _port_forward(t_scene, **over)
        return f(x0).numpy()

    assert np.max(np.abs(y(nlte=None) - base)) > 1e-6 * base.max()
    assert np.max(np.abs(y(cia=None) - base)) > 1e-6 * base.max()
    assert y(fov_V=None).shape != base.shape     # FOV changes the ray axis


def test_composed_retrieval_converges_with_parity(composed, single, ranks):
    """The composed sharded LM retrieval converges on every rank and lands
    on the single-device solution (same observations, same start)."""
    f, x_true, _, _ = single
    got, (y_obs, sigma, x0, S_a) = ranks
    x0_t = torch.as_tensor(x0)
    res_ref = retrieve(f, torch.func.jacfwd(f), y_obs, x0_t, x0_t, S_a,
                       sigma, OEConfig(max_iter=MAX_ITER))
    assert res_ref.converged
    n_lev = composed[1][0].n_lev
    for r, out in enumerate(got):
        x, converged, history = out["res"]
        assert converged, (r, history)
        np.testing.assert_allclose(x, res_ref.x, rtol=1e-6, atol=1e-5)
    # The 4.3 um prescribed-t_vib scene carries weak kinetic-T
    # information: require a genuine pull toward truth, not recovery.
    x_true = x_true.numpy()
    err0 = np.abs(x0[:n_lev] - x_true[:n_lev]).mean()
    err = np.abs(got[0]["res"][0][:n_lev] - x_true[:n_lev]).mean()
    assert err < err0 - 0.5, (err0, err)
