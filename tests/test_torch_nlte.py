"""Acceptance config 3 (non-LTE CO2 4.3 um limb emission with prescribed
vibrational populations) in the PyTorch port against the JAX package:
level matching, the weight algebra and its temperature tangent, the limb
pipeline against the reference and the float64 oracle, and the config-3
Jacobian (the K2 route) and reverse gradient (the K5 route), on the plain
versions in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import numpy_ref
from spectrobot_tpu.constants import C2
from spectrobot_tpu.data import nlte as j_nlte
from spectrobot_tpu.data import tips
from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_43um_band, co2_43um_hot_band
from spectrobot_tpu.forward.geometry import limb_path_cg as j_limb_path_cg
from spectrobot_tpu.forward.limb import limb_radiance as j_limb_radiance
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu.retrieval import state as jstate
from spectrobot_tpu_torch import interop
from spectrobot_tpu_torch.data import nlte as t_nlte
from spectrobot_tpu_torch.data import synth as t_synth
from spectrobot_tpu_torch.data.atmosphere import MARS
from spectrobot_tpu_torch.forward.geometry import limb_path_cg
from spectrobot_tpu_torch.forward.limb import limb_radiance
from spectrobot_tpu_torch.retrieval import state as tstate

torch.set_num_threads(1)

CPU = torch.device("cpu")
SPECIES = ["CO2"]
# float64 parity with the reference: within TOL of max |ref|.
TOL = 1e-10
# The float64 oracle (scipy wofz) against humlicek4: the budget of
# tests/test_config1_golden.py:57.
ORACLE_RTOL, ORACLE_ATOL_REL = 5e-3, 1e-4

_jit_limb = jax.jit(j_limb_radiance,
                    static_argnames=("variant", "cutoff_cm1", "chunk"))


def _numpy(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _tvib_profiles(reg, z_lev, T_lev):
    """Kinetic temps per layer + an excited nu3 stack above ~50 km (the
    reference test's profiles)."""
    z_mid = 0.5 * (z_lev[1:] + z_lev[:-1])
    T_lay = np.interp(z_mid, z_lev, T_lev)
    t_vib = t_nlte.lte_t_vib(reg, T_lay)
    boost = 1.0 + 0.35 * np.clip((z_mid - 50e3) / 40e3, 0.0, 1.0)
    for i, (m, iso, q) in enumerate(reg.keys):
        if q in ("0001", "0111"):
            t_vib[i] = T_lay * boost
    return t_vib, T_lay


@pytest.fixture(scope="module")
def scene():
    """The reference test's scene (16 levels, 801 points over 2320-2360
    cm-1, the 4.3 um fundamental and hot band) in both packages, float64."""
    atm = mars_standard_atmosphere(n_lev=16, z_top=90e3)
    ll = co2_43um_band(j_max=15).concat(co2_43um_hot_band(j_max=10))
    reg = j_nlte.registry_from_linelist(ll)
    ll = j_nlte.match_lines_to_levels(ll, reg)
    dl = j_stage(ll, [(2, 1)], dtype=jnp.float64)
    t_ll = t_synth.co2_43um_band(j_max=15).concat(
        t_synth.co2_43um_hot_band(j_max=10))
    t_reg = t_nlte.registry_from_linelist(t_ll)
    t_ll = t_nlte.match_lines_to_levels(t_ll, t_reg)
    z, T = np.asarray(atm.z), np.asarray(atm.T)
    t_vib, T_lay = _tvib_profiles(t_reg, z, T)
    d = {k: np.asarray(getattr(atm, k)) for k in ("z", "p", "T", "n")}
    d["vmr"] = {k: np.asarray(v) for k, v in atm.vmr.items()}
    return {"atm": atm, "ll": ll, "reg": reg, "dl": dl, "t_ll": t_ll,
            "t_reg": t_reg, "t_vib": t_vib, "T_lay": T_lay,
            "nu": np.linspace(2320.0, 2360.0, 801),
            "tatm": interop.atmosphere_from_numpy(d, device=CPU),
            "tl": interop.device_lines_from_numpy(_numpy(dl), device=CPU)}


def _j_nlte(sc, t_vib=None):
    return j_nlte.device_nlte(sc["reg"], sc["t_vib"] if t_vib is None
                              else t_vib, dtype=jnp.float64)


def _t_nlte(sc, t_vib=None):
    return t_nlte.device_nlte(sc["t_reg"], sc["t_vib"] if t_vib is None
                              else t_vib, dtype=torch.float64, device=CPU)


def test_registry_and_matching(scene):
    """The port's registry and level indices equal the reference's, and
    hold the reference test's facts."""
    reg, t_reg = scene["reg"], scene["t_reg"]
    assert t_reg.keys == reg.keys and t_reg.n_levels == 4
    np.testing.assert_array_equal(t_reg.energies_cm1, reg.energies_cm1)
    for f in ("level_upper", "level_lower"):
        np.testing.assert_array_equal(getattr(scene["t_ll"], f),
                                      getattr(scene["ll"], f))
        assert np.all(getattr(scene["t_ll"], f) >= 0)
    assert t_reg.energies_cm1[t_reg.lookup(2, 1, "0000")] < 1.0
    assert abs(t_reg.energies_cm1[t_reg.lookup(2, 1, "0001")]
               - 2349.14) < 2.0
    np.testing.assert_array_equal(scene["tl"].level_upper.numpy(),
                                  np.asarray(scene["dl"].level_upper))


def test_lte_weights_are_unity(scene):
    nlte = _t_nlte(scene, t_nlte.lte_t_vib(scene["t_reg"], scene["T_lay"]))
    wa, we = t_nlte.weights_for_layer(nlte, scene["tl"], 3,
                                      float(scene["T_lay"][3]))
    np.testing.assert_allclose(wa.numpy(), 1.0, rtol=1e-10)
    np.testing.assert_allclose(we.numpy(), 1.0, rtol=1e-10)
    none = t_nlte.weights_for_layer(None, scene["tl"], 3, 200.0)
    assert all(bool((w == 1.0).all()) for w in none)
    assert t_nlte.layer_weights(None, scene["tl"], torch.ones(2, 3)) is None


def test_weights_and_temperature_tangent_match_jax(scene):
    """weights_for_layer on every layer, its batched form over (ray,
    layer) and its temperature tangent (the division by 1 - E under
    forward mode) against the reference's values and jax.jvp."""
    sc, tl, dl = scene, scene["tl"], scene["dl"]
    jn, tn = _j_nlte(sc), _t_nlte(sc)
    NL = len(sc["T_lay"])
    T_air = sc["T_lay"][None, :] + np.array([[-3.0], [0.0], [4.5]])
    wa_b, we_b = t_nlte.layer_weights(tn, tl, torch.as_tensor(T_air))
    for lay in range(NL):
        for r in range(T_air.shape[0]):
            T = float(T_air[r, lay])
            ref = j_nlte.weights_for_layer(jn, dl, lay, T)
            got = t_nlte.weights_for_layer(tn, tl, lay, T)
            pairs = [(got[0], ref[0]), (got[1], ref[1]),
                     (wa_b[r, lay], ref[0]), (we_b[r, lay], ref[1])]
            if r != 1:
                for g, rf in pairs:
                    rf = np.asarray(rf)
                    np.testing.assert_allclose(g.numpy(), rf, rtol=0,
                                               atol=TOL * np.abs(rf).max())
                continue
            (ref_t, dref) = jax.jvp(
                lambda t: jnp.stack(j_nlte.weights_for_layer(jn, dl, lay, t)),
                (jnp.asarray(T),), (jnp.asarray(1.0),))
            (got_t, dgot) = torch.func.jvp(
                lambda t: torch.stack(t_nlte.weights_for_layer(tn, tl, lay,
                                                               t)),
                (torch.tensor(T, dtype=torch.float64),),
                (torch.tensor(1.0, dtype=torch.float64),))
            for g, rf in pairs + [(got_t, ref_t), (dgot, dref)]:
                rf = np.asarray(rf)
                np.testing.assert_allclose(g.numpy(), rf, rtol=0,
                                           atol=TOL * np.abs(rf).max())
    # The reference test's hand computation for line 0, aloft.
    lay, reg, ll = NL - 2, sc["t_reg"], sc["t_ll"]
    T_kin = float(sc["T_lay"][lay])
    wa, we = t_nlte.weights_for_layer(tn, tl, lay, T_kin)
    iu, il = int(ll.level_upper[0]), int(ll.level_lower[0])
    r = [np.exp(-C2 * reg.energies_cm1[i] * (1 / sc["t_vib"][i, lay]
                                              - 1 / T_kin)) for i in (iu, il)]
    E = np.exp(-C2 * ll.nu0[0] / T_kin)
    np.testing.assert_allclose(float(wa[0]), (r[1] - r[0] * E) / (1 - E),
                               rtol=1e-10)
    np.testing.assert_allclose(float(we[0]), r[0], rtol=1e-10)
    assert float((wa_b - we_b).abs().max()) > 0.1      # the rows differ


def _oracle(sc, h_t):
    ll, t_vib = sc["ll"], sc["t_vib"]
    e_lvl = np.asarray(sc["reg"].energies_cm1)
    atm = sc["atm"]

    def q_ratio_fn(name, T):
        return np.full(len(ll), tips.q_of_T(2, 1, 296.0)
                       / tips.q_of_T(2, 1, T))

    def nlte_weights_fn(name, lay, T_kin):
        r = np.exp(-C2 * e_lvl * (1 / t_vib[:, lay] - 1 / T_kin))
        r_u = np.where(ll.level_upper >= 0,
                       r[np.maximum(ll.level_upper, 0)], 1.0)
        r_l = np.where(ll.level_lower >= 0,
                       r[np.maximum(ll.level_lower, 0)], 1.0)
        E = np.exp(-C2 * ll.nu0 / T_kin)
        return (r_l - r_u * E) / (1 - E), r_u

    return np.stack([numpy_ref.limb_radiance(
        sc["nu"], {"CO2": ll}, np.asarray(atm.z), np.asarray(atm.p),
        np.asarray(atm.T), np.asarray(atm.n),
        {k: np.asarray(v) for k, v in atm.vmr.items()}, J_MARS.radius_m,
        ht, SPECIES, q_ratio_fn, cutoff=25.0, n_sub=4,
        nlte_weights_fn=nlte_weights_fn) for ht in h_t])


def test_config3_limb_vs_jax_and_oracle(scene):
    """The config-3 limb through the port's plain line sum: within TOL of
    the reference's (same Voigt variant), and within the humlicek4 budget
    of the float64 oracle."""
    sc = scene
    h_t = np.array([40e3, 70e3])
    cg = j_limb_path_cg(sc["atm"], SPECIES, jnp.asarray(h_t), J_MARS,
                        n_sub=4)
    ref = np.asarray(_jit_limb(jnp.asarray(sc["nu"]), sc["dl"], cg,
                               _j_nlte(sc), variant="humlicek4",
                               cutoff_cm1=25.0))
    tcg = limb_path_cg(sc["tatm"], SPECIES, torch.as_tensor(h_t), MARS, 4)
    got = limb_radiance(torch.as_tensor(sc["nu"]), sc["tl"], tcg,
                        nlte=_t_nlte(sc), cutoff_cm1=25.0).numpy()
    assert np.isfinite(got).all() and (got >= 0).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * ref.max())
    oracle = _oracle(sc, h_t)
    np.testing.assert_allclose(got, oracle, rtol=ORACLE_RTOL,
                               atol=ORACLE_ATOL_REL * oracle.max())


def test_nlte_enhances_high_limb_emission(scene):
    """Pumped nu3 brightens the high limb; zero level energies force
    r_u = r_l = 1 and equal the LTE path (nlte=None)."""
    sc = scene
    cg = limb_path_cg(sc["tatm"], SPECIES, torch.as_tensor([75e3],
                                                           dtype=torch.float64),
                      MARS)
    nu = torch.as_tensor(sc["nu"])
    run = lambda n: limb_radiance(nu, sc["tl"], cg, nlte=n).numpy()
    hot = run(_t_nlte(sc))
    cold = run(_t_nlte(sc, t_nlte.lte_t_vib(sc["t_reg"], sc["T_lay"])))
    assert hot.sum() > 1.5 * cold.sum()
    none = run(None)
    hot_n = _t_nlte(sc)
    zero = run(t_nlte.DeviceNLTE(e_level=torch.zeros_like(hot_n.e_level),
                                 t_vib=hot_n.t_vib))
    np.testing.assert_allclose(zero, none, rtol=1e-12)


def _forward_pair(sc, analytic_jvp):
    """The config-3 forward T -> y in both packages (two limb rays, every
    fourth grid point, no ILS), the same analytic mode on each side."""
    h_t = np.array([45e3, 65e3])
    nu = sc["nu"][::4]
    jf = jstate.build_forward(
        sc["atm"], sc["dl"], jnp.asarray(nu), SPECIES, J_MARS,
        tangent_heights_m=jnp.asarray(h_t), nlte=_j_nlte(sc), n_sub=2,
        analytic_jvp=analytic_jvp)
    tf = tstate.build_forward(
        sc["tatm"], sc["tl"], torch.as_tensor(nu), SPECIES, MARS,
        tangent_heights_m=torch.as_tensor(h_t), nlte=_t_nlte(sc), n_sub=2,
        analytic_jvp=analytic_jvp)
    return (lambda T: jf({"T": T, "ln_vmr": {}}),
            lambda T: tf({"T": T, "ln_vmr": {}}), np.array(sc["atm"].T))


def test_config3_jacobian_and_gradient_match_jax(scene):
    """The config-3 Jacobian by torch.func.jacfwd (the K2 route) against
    jax.jacfwd, and the gradient of a cost by analytic_jvp='rev' (the K5
    route) against jax.grad, float64."""
    jf, tf, T0 = _forward_pair(scene, True)
    J_ref = np.asarray(jax.jit(jax.jacfwd(jf))(jnp.asarray(T0)))
    J = torch.func.jacfwd(tf)(torch.as_tensor(T0)).numpy()
    assert J.shape == J_ref.shape and np.isfinite(J).all()
    np.testing.assert_allclose(J, J_ref, rtol=0,
                               atol=TOL * np.abs(J_ref).max())
    jf, tf, T0 = _forward_pair(scene, "rev")
    w = np.random.default_rng(3).normal(size=J_ref.shape[0])
    g_ref = np.asarray(jax.jit(jax.grad(lambda T: jnp.sum(jnp.asarray(w) * jf(T)
                                                  ** 2)))(jnp.asarray(T0)))
    T = torch.as_tensor(T0).requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(torch.as_tensor(w) * tf(T) ** 2),
                               T)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=0,
                               atol=TOL * np.abs(g_ref).max())
