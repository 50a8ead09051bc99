"""The non-LTE (P, T) table tier of the PyTorch port (ops/lut.py NLTELUT)
against the JAX package, in float64 on the plain versions: the group maps,
the per-group tables (one and two species, with and without chi), the
depths through the tables and their tangents in T and in the vibrational
temperatures, the forward and its Jacobian through the tables, files
written by either package; and tests/test_nlte_lut.py's checks in the
port (the node-exact decomposition, the LTE reduction and the limb
radiance against the direct line sum)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data import nlte as j_nlte
from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import (
    co2_43um_band, co2_43um_hot_band, co_fundamental)
from spectrobot_tpu.forward import geometry as jgeo
from spectrobot_tpu.ops import chi as j_chi
from spectrobot_tpu.ops import lut as jlut
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu.retrieval import state as jstate
from spectrobot_tpu_torch import interop
from spectrobot_tpu_torch.data import nlte as t_nlte
from spectrobot_tpu_torch.data.atmosphere import MARS
from spectrobot_tpu_torch.forward.limb import (
    layer_tau_kernel, optics_from_tau, path_radiance)
from spectrobot_tpu_torch.forward import geometry as tgeo
from spectrobot_tpu_torch.ops import chi as t_chi
from spectrobot_tpu_torch.ops import lut as tlut
from spectrobot_tpu_torch.ops.cuda_basis import PLAIN
from spectrobot_tpu_torch.ops.opacity import cross_sections
from spectrobot_tpu_torch.retrieval import state as tstate

torch.set_num_threads(1)

CPU = torch.device("cpu")
# float64 parity with the reference where both compute the same sums.
TOL = 1e-10
LATTICE = dict(T_min=110.0, T_max=260.0, n_T=5, p_min=1e-3, p_max=1.5e3,
               n_p=6, chunk=128)
SPECIES = {"co2": ["CO2"], "co2+co": ["CO2", "CO"]}


def _numpy(nt) -> dict:
    return {k: (v if v is None or isinstance(v, (bool, int))
                else np.asarray(v)) for k, v in nt._asdict().items()}


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def _tvib(reg, z_lev, T_lev):
    """LTE t_vib with the nu3 stack excited above ~50 km (the reference
    test's profiles)."""
    z_mid = 0.5 * (z_lev[1:] + z_lev[:-1])
    T_lay = np.interp(z_mid, z_lev, T_lev)
    t_vib = j_nlte.lte_t_vib(reg, T_lay)
    boost = 1.0 + 0.35 * np.clip((z_mid - 50e3) / 40e3, 0.0, 1.0)
    for i, (_, _, q) in enumerate(reg.keys):
        if q in ("0001", "0111"):
            t_vib[i] = T_lay * boost
    return t_vib


@pytest.fixture(scope="module")
def scene():
    """The 4.3 um fundamental and hot band (matched to their levels) over
    200 points, 7 levels to 90 km; with CO (its fundamental moved into the
    band, matched to its own two levels) for two species rows."""
    atm = mars_standard_atmosphere(n_lev=7, z_top=90e3)
    d = {k: np.asarray(getattr(atm, k)) for k in ("z", "p", "T", "n")}
    d["vmr"] = {k: np.asarray(v) for k, v in atm.vmr.items()}
    out = {"jatm": atm, "atm": interop.atmosphere_from_numpy(d, device=CPU),
           "nu": np.linspace(2320.0, 2360.0, 200), "luts": {}}
    for name, species in SPECIES.items():
        ll = co2_43um_band(j_max=12).concat(co2_43um_hot_band(j_max=8))
        pairs = [(2, 1)]
        if "CO" in species:
            co = co_fundamental(j_max=6)
            co.nu0[:] = co.nu0 - 2143.27 + 2340.0
            ll, pairs = ll.concat(co), [(2, 1), (5, 1)]
        reg = j_nlte.registry_from_linelist(ll)
        ll = j_nlte.match_lines_to_levels(ll, reg)
        dl = j_stage(ll, pairs, dtype=jnp.float64)
        t_vib = _tvib(reg, d["z"], d["T"])
        jn = j_nlte.device_nlte(reg, t_vib, dtype=jnp.float64)
        out[name] = {"jdl": dl, "dl": interop.device_lines_from_numpy(
            _numpy(dl), device=CPU), "reg": reg, "jnlte": jn,
            "nlte": t_nlte.DeviceNLTE(torch.tensor(np.asarray(jn.e_level)),
                                      torch.tensor(np.asarray(jn.t_vib)))}
    return out


def _chi(species, port: bool):
    prof = (t_chi if port else j_chi).CHI_PROFILES["co2_mars"]
    return (prof, tuple(s == "CO2" for s in species))


def _tables(scene, name, with_chi=False):
    key = (name, with_chi)
    if key not in scene["luts"]:
        species, sc = SPECIES[name], scene[name]
        kw = dict(LATTICE, vmr_self=[0.95, 7e-4][:len(species)])
        ref = jlut.build_nlte_lut(
            jnp.asarray(scene["nu"]), sc["jdl"], len(species),
            chi=_chi(species, False) if with_chi else None, **kw)
        got = tlut.build_nlte_lut(
            torch.as_tensor(scene["nu"]), sc["dl"], len(species),
            chi=_chi(species, True) if with_chi else None, **kw)
        scene["luts"][key] = (ref, got)
    return scene["luts"][key]


@pytest.mark.parametrize("name", sorted(SPECIES))
def test_group_maps_match_jax(scene, name):
    """Each line's lower and upper group and the group -> species and
    group -> level maps equal the reference's: one LTE group per species,
    then the registry's levels."""
    sc = scene[name]
    ref = jlut._line_groups(sc["jdl"], len(SPECIES[name]))
    got = tlut._line_groups(sc["dl"], len(SPECIES[name]))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    assert len(got[3]) == len(SPECIES[name]) + sc["reg"].n_levels
    assert got[2][0] == 0 and np.all(got[3][:len(SPECIES[name])] == -1)


@pytest.mark.parametrize("name,with_chi", [("co2", False),
                                           ("co2+co", False),
                                           ("co2+co", True)])
def test_build_nlte_lut_matches_jax(scene, name, with_chi):
    """The 3G tables at every node (3G rows paired into K1 states: 15 for
    CO2 alone, an odd count; 24 with CO's two levels) and the group
    maps."""
    ref, got = _tables(scene, name, with_chi)
    assert got.n_groups == ref.n_groups
    for f in ("sigma_l", "sigma_u", "sigma_e"):
        assert tuple(getattr(got, f).shape) == getattr(ref, f).shape
        _close(getattr(got, f), getattr(ref, f))
    for f in ("group_species", "group_level"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    # Every line is matched to its levels: the LTE groups' tables are zero.
    S = len(SPECIES[name])
    assert float(got.sigma_l[:S].abs().max()) == 0.0
    assert float(got.sigma_e[:S].abs().max()) == 0.0
    assert set(got.group_species.tolist()) == set(range(S))


def _cg(scene, species, h_t=(40e3, 60e3, 75e3)):
    cg = jgeo.limb_path_cg(scene["jatm"], species, jnp.asarray(h_t), J_MARS,
                           n_sub=2)
    return cg, interop.path_cg_from_numpy(_numpy(cg), device=CPU)


@pytest.mark.parametrize("with_nlte", [True, False])
def test_layer_tau_nlte_lut_matches_jax(scene, with_nlte):
    """(dtau, dtau_em) through the tables, with the non-LTE populations and
    without (r = 1); the two depths differ under the pumping."""
    ref, got = _tables(scene, "co2+co")
    sc = scene["co2+co"]
    jcg, tcg = _cg(scene, SPECIES["co2+co"])
    jd = jlut.layer_tau_nlte_lut(ref, jcg, sc["jnlte"] if with_nlte
                                 else None)
    td = tlut.layer_tau_nlte_lut(got, tcg, sc["nlte"] if with_nlte
                                 else None)
    for g, r in zip(td, jd):
        _close(g, r)
    gap = float((td[0] - td[1]).abs().max()) / float(td[0].abs().max())
    assert (gap > 1e-3) if with_nlte else (gap < 1e-12)


@pytest.mark.parametrize("field", ["T_sp", "t_vib"])
def test_layer_tau_nlte_lut_jvp_matches_jax(scene, field):
    """The tangents of both depths in the Curtis-Godson temperatures and in
    the vibrational temperatures (a retrieval of T_vib against the cached
    tables), off the lattice nodes."""
    ref, got = _tables(scene, "co2+co")
    sc = scene["co2+co"]
    jcg, tcg = _cg(scene, SPECIES["co2+co"])
    if field == "T_sp":
        x = np.asarray(jcg.T_sp)
        jf = lambda a: jlut.layer_tau_nlte_lut(ref, jcg._replace(T_sp=a),
                                               sc["jnlte"])
        tf = lambda a: tlut.layer_tau_nlte_lut(got, tcg._replace(T_sp=a),
                                               sc["nlte"])
    else:
        x = np.asarray(sc["jnlte"].t_vib)
        jf = lambda a: jlut.layer_tau_nlte_lut(
            ref, jcg, sc["jnlte"]._replace(t_vib=a))
        tf = lambda a: tlut.layer_tau_nlte_lut(
            got, tcg, sc["nlte"]._replace(t_vib=a))
    v = np.random.default_rng(5).normal(size=x.shape) * 0.01 * x
    _, jt = jax.jvp(jf, (jnp.asarray(x),), (jnp.asarray(v),))
    _, tt = torch.func.jvp(tf, (torch.tensor(x),), (torch.tensor(v),))
    for g, r in zip(tt, jt):
        assert float(np.abs(np.asarray(r)).max()) > 0.0
        _close(g, r)


@pytest.mark.parametrize("mode", ["limb", "nadir"])
def test_build_forward_lut_nlte_matches_jax(scene, mode):
    """The forward through the non-LTE tables (limb, or nadir over a grey
    surface) and its jacfwd Jacobian over T and ln VMR(CO)."""
    ref, got = _tables(scene, "co2+co")
    sc = scene["co2+co"]
    species = SPECIES["co2+co"]
    rays = (np.array([40e3, 60e3, 75e3]) if mode == "limb"
            else np.array([1.0, 1.3]))
    key = "tangent_heights_m" if mode == "limb" else "sec_theta"
    extra = {} if mode == "limb" else {"T_surface": 230.0,
                                       "emissivity": 0.9}
    jf = jstate.build_forward_lut(scene["jatm"], ref, species, J_MARS,
                                  nlte=sc["jnlte"], n_sub=2,
                                  **{key: jnp.asarray(rays)}, **extra)
    tf = tstate.build_forward_lut(scene["atm"], got, species, MARS,
                                  nlte=sc["nlte"], n_sub=2,
                                  **{key: torch.as_tensor(rays)}, **extra)
    jx, ju = jstate.flatten_state(jstate.make_state(scene["jatm"], ["CO"]))
    tx, tu = tstate.flatten_state(tstate.make_state(scene["atm"], ["CO"]))
    _close(tf(tu(tx)), jf(ju(jx)))
    _close(torch.func.jacfwd(lambda x: tf(tu(x)))(tx),
           jax.jacfwd(lambda x: jf(ju(x)))(jx))


def test_nlte_tables_load_across_packages(scene, tmp_path):
    """A non-LTE table written by either package loads in the other, with
    the same depths (group maps int32 on file, as the reference writes
    them)."""
    ref, got = _tables(scene, "co2+co")
    sc = scene["co2+co"]
    jcg, tcg = _cg(scene, SPECIES["co2+co"])
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jlut.save_nlte_lut(ref, jpath, fingerprint="j")
    tlut.save_nlte_lut(got, tpath, fingerprint="t")
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, f
    want = jlut.layer_tau_nlte_lut(ref, jcg, sc["jnlte"])
    back = tlut.load_nlte_lut(jpath, device=CPU)
    for g, r in zip(tlut.layer_tau_nlte_lut(back, tcg, sc["nlte"]), want):
        _close(g, r)
    for g, r in zip(jlut.layer_tau_nlte_lut(jlut.load_nlte_lut(tpath), jcg,
                                            sc["jnlte"]), want):
        _close(g, r)
    same = tlut.load_nlte_lut(tpath, device=CPU)
    for f in tlut.NLTELUT._fields:
        assert torch.equal(getattr(same, f), getattr(got, f)), f


@pytest.fixture(scope="module")
def fine(scene):
    """The one-species scene's tables on tests/test_nlte_lut.py's finer
    lattice (13 x 17), for the checks against the direct line sum."""
    sc = scene["co2"]
    T = scene["atm"].T.numpy()
    return tlut.build_nlte_lut(
        torch.as_tensor(scene["nu"]), sc["dl"], 1,
        T_min=float(T.min()) - 20.0, T_max=float(T.max()) + 40.0, n_T=13,
        p_min=1e-3, p_max=1.5e3, n_p=17, vmr_self=[0.95])


def test_node_exact_decomposition(scene, fine):
    """At a lattice node the group decomposition reproduces the direct
    weighted line sum to roundoff (the module docstring's algebra)."""
    sc = scene["co2"]
    nu = torch.as_tensor(scene["nu"])
    T0, p0 = float(fine.T_grid[8]), 10.0 ** float(fine.logp_grid[9])
    lay = 4
    w_abs, w_em = t_nlte.weights_for_layer(sc["nlte"], sc["dl"], lay, T0)
    k_abs, k_em = cross_sections(nu, sc["dl"], T0, p0, p_self_pa=0.95 * p0,
                                 w_abs=w_abs, w_em=w_em, analytic_jvp=False)
    r = tlut.nlte_group_ratios(fine, sc["nlte"], lay, T0)
    assert float((r - 1.0).abs().max()) > 1e-3
    interp = lambda t: tlut._bilinear_tq(t, fine.T_grid, fine.logp_grid, T0,
                                         p0)
    scale = float(k_abs.abs().max())
    np.testing.assert_allclose((r @ (interp(fine.sigma_l)
                                     - interp(fine.sigma_u))).numpy(),
                               k_abs.numpy(), rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose((r @ interp(fine.sigma_e)).numpy(),
                               k_em.numpy(), rtol=0, atol=1e-9 * scale)


def test_lte_reduction_and_radiance_vs_direct(scene, fine):
    """Without populations the tier reduces to the LTE line sum (dtau_em
    == dtau) within interpolation error; with them the limb radiance
    through the tables agrees with the direct non-LTE radiance, which the
    pumping moves away from LTE."""
    sc = scene["co2"]
    nu = torch.as_tensor(scene["nu"])
    nu_off = nu - float(sc["dl"].nu_ref)
    cg = tgeo.limb_path_cg(scene["atm"], ["CO2"],
                           torch.tensor([40e3, 60e3, 75e3],
                                        dtype=torch.float64), MARS, n_sub=2)
    direct = lambda nlte: layer_tau_kernel(nu_off, sc["dl"], cg, None,
                                           engine=PLAIN, analytic_jvp=False,
                                           nlte=nlte)
    dtau, dtau_em = tlut.layer_tau_nlte_lut(fine, cg, None)
    d_lte = direct(None)
    assert float((dtau - d_lte[0]).abs().max()) / float(d_lte[0].max()) \
        < 0.03
    np.testing.assert_allclose(dtau_em.numpy(), dtau.numpy(), rtol=1e-10)

    radiance = lambda d: path_radiance(optics_from_tau(nu, cg, *d), cg, None)
    I_lut = radiance(tlut.layer_tau_nlte_lut(fine, cg, sc["nlte"]))
    I_dir, I_lte = radiance(direct(sc["nlte"])), radiance(d_lte)
    assert float((I_dir - I_lte).abs().max()) > 0.05 * float(I_lte.max())
    assert float((I_lut - I_dir).abs().max()) / float(I_dir.max()) < 0.03
