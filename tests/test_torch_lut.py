"""The LTE (P, T) table tier of the PyTorch port (ops/lut.py,
retrieval/state.py:build_forward_lut, parallel/sharded_lut.py) against the
JAX package, in float64 on the plain versions: the tables (one and two
species, with and without chi), the interpolation and its tangents off
the nodes, the cache, files written by either package, the forward and
its Jacobian through the table (limb, nadir, with CIA and FOV), the
build's route through the engine, and the lattice build and sharded
runtime on gloo ranks (tests/test_lut.py's cases among them)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band, co_fundamental
from spectrobot_tpu.forward import geometry as jgeo
from spectrobot_tpu.ops import chi as j_chi
from spectrobot_tpu.ops import cia as j_cia
from spectrobot_tpu.ops import ils as j_ils
from spectrobot_tpu.ops import lut as jlut
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu.retrieval import state as jstate
from spectrobot_tpu_torch import interop
from spectrobot_tpu_torch.data.atmosphere import MARS
from spectrobot_tpu_torch.forward import geometry as tgeo
from spectrobot_tpu_torch.ops import chi as t_chi
from spectrobot_tpu_torch.ops import cia as t_cia
from spectrobot_tpu_torch.ops import lut as tlut
from spectrobot_tpu_torch.ops.opacity import cross_sections
from spectrobot_tpu_torch.retrieval import state as tstate

import torch_mesh_cases as cases

torch.set_num_threads(1)

CPU = torch.device("cpu")
# float64 parity with the reference where both compute the same sums:
# within TOL of max |ref|.
TOL = 1e-10
# A 5 x 6 lattice spanning the 7-level scene's temperatures and pressures.
LATTICE = dict(T_min=120.0, T_max=300.0, n_T=5, p_min=1e-2, p_max=1.2e3,
               n_p=6, chunk=128)
SPECIES = {"co2": ["CO2"], "co2+co": ["CO2", "CO"]}
SCENE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "mars_limb.toml")


def _numpy(nt) -> dict:
    return {k: (v if v is None or isinstance(v, (bool, int))
                else np.asarray(v)) for k, v in nt._asdict().items()}


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def _lines(species):
    """The 15 um CO2 band, with CO (its fundamental moved into the band)
    for two species rows."""
    ll = co2_15um_band(j_max=12)
    pairs = [(2, 1)]
    if "CO" in species:
        co = co_fundamental(j_max=6)
        co.nu0[:] = co.nu0 - 2143.27 + 662.0
        ll, pairs = ll.concat(co), [(2, 1), (5, 1)]
    return j_stage(ll, pairs, dtype=jnp.float64)


@pytest.fixture(scope="module")
def scene():
    atm = mars_standard_atmosphere(n_lev=7, z_top=60e3)
    nu = np.linspace(655.0, 680.0, 200)
    d = {k: np.asarray(getattr(atm, k)) for k in ("z", "p", "T", "n")}
    d["vmr"] = {k: np.asarray(v) for k, v in atm.vmr.items()}
    out = {"jatm": atm, "atm": interop.atmosphere_from_numpy(d, device=CPU),
           "nu": nu, "luts": {}}
    for name, species in SPECIES.items():
        dl = _lines(species)
        out[name] = (dl, interop.device_lines_from_numpy(_numpy(dl),
                                                         device=CPU))
    return out


def _chi(species, port: bool):
    prof = (t_chi if port else j_chi).CHI_PROFILES["co2_mars"]
    return (prof, tuple(s == "CO2" for s in species))


def _tables(scene, name, with_chi=False):
    """(JAX table, port table) of one species set, built once each."""
    key = (name, with_chi)
    if key not in scene["luts"]:
        species = SPECIES[name]
        jdl, tdl = scene[name]
        vs = [0.95, 7e-4][:len(species)]
        kw = dict(LATTICE, vmr_self=vs)
        ref = jlut.build_lut(jnp.asarray(scene["nu"]), jdl, len(species),
                             chi=_chi(species, False) if with_chi else None,
                             **kw)
        got = tlut.build_lut(torch.as_tensor(scene["nu"]), tdl,
                             len(species),
                             chi=_chi(species, True) if with_chi else None,
                             **kw)
        scene["luts"][key] = (ref, got)
    return scene["luts"][key]


@pytest.mark.parametrize("name,with_chi", [("co2", False),
                                           ("co2+co", False),
                                           ("co2+co", True)])
def test_build_lut_matches_jax(scene, name, with_chi):
    """Every node of the table, each species row its own line sum (two
    rows a K1 state, so CO2 + CO shares states), chi baked in."""
    ref, got = _tables(scene, name, with_chi)
    assert tuple(got.sigma.shape) == ref.sigma.shape == (
        len(SPECIES[name]), 5, 6, 200)
    for f in ("T_grid", "logp_grid", "vmr_self", "nu_grid"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-15)
    for s in range(len(SPECIES[name])):
        _close(got.sigma[s], ref.sigma[s])
        assert float(got.sigma[s].max()) > 0.0
    if with_chi:
        plain = _tables(scene, name)[1]
        assert float((plain.sigma - got.sigma).abs().max()) > 0.0


@pytest.mark.parametrize("T,p", [(165.0, 10 ** 0.4),       # on a node
                                 (201.7, 37.3),            # between nodes
                                 (90.0, 5e3)])             # clamped
def test_interp_sigma_matches_jax(scene, T, p):
    ref, got = _tables(scene, "co2+co")
    _close(tlut.interp_sigma(got, T, p), jlut.interp_sigma(ref, T, p))


def _cg(scene, species, h_t=(8e3, 20e3, 35e3)):
    cg = jgeo.limb_path_cg(scene["jatm"], species, jnp.asarray(h_t), J_MARS,
                           n_sub=2)
    return cg, interop.path_cg_from_numpy(_numpy(cg), device=CPU)


def test_layer_tau_lut_matches_jax(scene):
    ref, got = _tables(scene, "co2+co")
    jcg, tcg = _cg(scene, SPECIES["co2+co"])
    _close(tlut.layer_tau_lut(got, tcg), jlut.layer_tau_lut(ref, jcg))


@pytest.mark.parametrize("field", ["T_sp", "p_sp", "u"])
def test_layer_tau_lut_jvp_matches_jax(scene, field):
    """The tangent of the table depths in each Curtis-Godson input, off the
    lattice nodes (the states of the limb scene lie between them)."""
    ref, got = _tables(scene, "co2+co")
    jcg, tcg = _cg(scene, SPECIES["co2+co"])
    x = np.asarray(getattr(jcg, field))
    v = np.random.default_rng(3).normal(size=x.shape) * x

    _, jt = jax.jvp(lambda a: jlut.layer_tau_lut(ref, jcg._replace(
        **{field: a})), (jnp.asarray(x),), (jnp.asarray(v),))
    _, tt = torch.func.jvp(lambda a: tlut.layer_tau_lut(got, tcg._replace(
        **{field: a})), (torch.as_tensor(x),), (torch.as_tensor(v),))
    assert float(np.abs(np.asarray(jt)).max()) > 0.0
    _close(tt, jt)


def test_lut_matches_direct_and_differentiates(scene):
    """tests/test_lut.py's checks in the port: at a node the table is the
    direct cross section; between nodes within interpolation error; the
    derivative in T off the nodes matches a central difference."""
    dl = scene["co2"][1]
    nu = torch.as_tensor(np.linspace(660.0, 674.0, 400))
    # tests/test_lut.py's lattice (its interpolation error is ~1 %).
    got = tlut.build_lut(nu, dl, 1, T_min=140.0, T_max=280.0, n_T=15,
                         p_min=1e-2, p_max=1e3, n_p=21, vmr_self=[0.95])
    T0, p0 = float(got.T_grid[7]), 10.0 ** float(got.logp_grid[10])
    direct, _ = cross_sections(nu, dl, T0, p0, p_self_pa=0.95 * p0,
                               analytic_jvp=False)
    _close(tlut.interp_sigma(got, T0, p0)[0], direct.numpy())
    T1, p1 = 201.7, 37.3
    direct, _ = cross_sections(nu, dl, T1, p1, p_self_pa=0.95 * p1,
                               analytic_jvp=False)
    d = direct.numpy()
    g = tlut.interp_sigma(got, T1, p1)[0].numpy()
    assert np.max(np.abs(g - d) / np.maximum(d, d.max() * 1e-4)) < 0.05

    def f(T):
        return torch.sum(tlut.interp_sigma(got, T, 50.0))

    T = torch.tensor(203.7, dtype=torch.float64, requires_grad=True)
    (grad,) = torch.autograd.grad(f(T), T)
    fd = (f(T.detach() + 0.05) - f(T.detach() - 0.05)) / 0.1
    np.testing.assert_allclose(grad.item(), fd.item(), rtol=1e-6)


def test_cache_hit_and_invalidation(scene, tmp_path):
    """A persisted table is keyed to its inputs: a matching file skips the
    build, any change of the lattice, of the lines or of chi rebuilds."""
    dl = scene["co2"][1]
    nu = torch.as_tensor(scene["nu"][:120])
    path = str(tmp_path / "lut.npz")
    kw = dict(LATTICE, n_T=3, n_p=4, vmr_self=[0.95])
    lut1, hit1 = tlut.get_or_build_lut(path, nu, dl, 1, **kw)
    lut2, hit2 = tlut.get_or_build_lut(path, nu, dl, 1, **kw)
    assert (hit1, hit2) == (False, True)
    assert torch.equal(lut1.sigma, lut2.sigma)
    assert not tlut.get_or_build_lut(path, nu, dl, 1, **{**kw, "n_T": 4})[1]
    dl2 = dl._replace(nu_ref=dl.nu_ref + 1.0, nu0=dl.nu0 - 1.0)
    assert not tlut.get_or_build_lut(path, nu, dl2, 1, **kw)[1]
    chi = _chi(["CO2"], True)
    assert not tlut.get_or_build_lut(path, nu, dl, 1, chi=chi, **kw)[1]
    assert tlut.get_or_build_lut(path, nu, dl, 1, chi=chi, **kw)[1]
    # chi is keyed by its numbers, whatever holds them.
    assert tlut.lut_fingerprint(nu, dl, chi=chi) == tlut.lut_fingerprint(
        nu, dl, chi=(chi[0], torch.tensor(chi[1])))


def test_tables_load_across_packages(scene, tmp_path):
    """A table written by the JAX package loads in the port with the same
    depths, and one written by the port loads in the JAX package."""
    ref, got = _tables(scene, "co2+co")
    jcg, tcg = _cg(scene, SPECIES["co2+co"])
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jlut.save_lut(ref, jpath, fingerprint="j")
    tlut.save_lut(got, tpath, fingerprint="t")
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
    assert tlut.stored_fingerprint(jpath) == "j"
    assert jlut.stored_fingerprint(tpath) == "t"
    from_jax = tlut.load_lut(jpath, device=CPU)
    from_port = jlut.load_lut(tpath)
    want = jlut.layer_tau_lut(ref, jcg)
    _close(tlut.layer_tau_lut(from_jax, tcg), want)
    _close(jlut.layer_tau_lut(from_port, jcg), want)


def _forward_pair(scene, variant):
    """(JAX, port) flat forwards through the same table over the state T +
    ln VMR(CO), and the state: limb, nadir, or the limb with the CIA
    continuum and a 3-ray FOV ladder smeared into 2 observed rays."""
    ref, got = _tables(scene, "co2+co")
    species = SPECIES["co2+co"]
    kw = dict(n_sub=2)
    jkw, tkw = dict(kw), dict(kw)
    if variant == "nadir":
        sec = np.array([1.0, 1.3])
        jkw.update(sec_theta=jnp.asarray(sec), T_surface=230.0,
                   emissivity=0.9)
        tkw.update(sec_theta=torch.as_tensor(sec), T_surface=230.0,
                   emissivity=0.9)
    else:
        h = np.array([8e3, 20e3, 35e3])
        jkw["tangent_heights_m"] = jnp.asarray(h)
        tkw["tangent_heights_m"] = torch.as_tensor(h)
    if variant == "limb-cia-fov":
        V = j_ils.fov_matrix(h, np.array([12e3, 28e3]), fwhm_m=8e3)
        jkw["fov_V"], tkw["fov_V"] = jnp.asarray(V), torch.as_tensor(V)
        nu = scene["nu"]
        jkw["cia"] = j_cia.stage_cia(jnp.asarray(nu), [j_cia.demo_co2_cia()],
                                     species, dtype=jnp.float64)
        tkw["cia"] = t_cia.stage_cia(nu, [t_cia.demo_co2_cia()], species,
                                     dtype=torch.float64, device=CPU)
    jf = jstate.build_forward_lut(scene["jatm"], ref, species, J_MARS, **jkw)
    tf = tstate.build_forward_lut(scene["atm"], got, species, MARS, **tkw)
    jx, junravel = jstate.flatten_state(jstate.make_state(scene["jatm"],
                                                          ["CO"]))
    tx, tunravel = tstate.flatten_state(tstate.make_state(scene["atm"],
                                                          ["CO"]))
    return (lambda x: jf(junravel(x))), (lambda x: tf(tunravel(x))), jx, tx


@pytest.mark.parametrize("variant", ["limb", "nadir", "limb-cia-fov"])
def test_build_forward_lut_matches_jax(scene, variant):
    """The forward through the table and its jacfwd Jacobian (33 columns
    of T and ln VMR(CO) tangents through the interpolation)."""
    jf, tf, jx, tx = _forward_pair(scene, variant)
    y_ref = jax.jit(jf)(jx)
    assert np.all(np.isfinite(np.asarray(y_ref)))
    _close(tf(tx), y_ref)
    K_ref = jax.jacfwd(jf)(jx)
    K = torch.func.jacfwd(tf)(tx)
    assert K.shape == K_ref.shape
    _close(K, K_ref)


def test_table_build_goes_through_the_engine(scene, monkeypatch):
    """Every line sum of a table build is one ``engine.accumulate`` call
    (K1 on the card) on states whose two rows are two species' masks;
    none is a plain slab sum."""
    from spectrobot_tpu_torch.ops import cuda_opacity, opacity
    from spectrobot_tpu_torch.ops.opacity import Engine

    def refuse(*a, **k):
        raise AssertionError("a plain line sum ran in the table build")

    for mod, name in ((opacity, "line_sum_plain_ad"),
                      (opacity, "accumulate_plain"),
                      (cuda_opacity, "accumulate_batch_plain")):
        monkeypatch.setattr(mod, name, refuse)
    seen = []

    def record(nu, windows, nu_c, sx, y, amps, *, cutoff_cm1, chi_b):
        seen.append((windows, nu_c.shape, amps.detach().clone()))
        return torch.zeros(amps.shape[:-1] + nu.shape, dtype=nu.dtype)

    dl = scene["co2+co"][1]
    nu = torch.as_tensor(scene["nu"])
    lut = tlut.build_lut(nu, dl, 2, engine=Engine("record", record, None),
                         **LATTICE)
    assert float(lut.sigma.abs().max()) == 0.0
    ((windows, shape, amps),) = seen
    assert shape == (5 * 6, dl.n_lines)
    assert windows.n_points == 200 and windows.n_lines == dl.n_lines
    co2 = (dl.species_idx == 0).numpy()
    assert np.all(amps[:, 0, ~co2].numpy() == 0) and np.all(
        amps[:, 0, co2].numpy() > 0)
    assert np.all(amps[:, 1, co2].numpy() == 0) and np.all(
        amps[:, 1, ~co2].numpy() > 0)
    for mod in (opacity, cuda_opacity):
        monkeypatch.undo()


def test_mesh_build_and_sharded_runtime_match_one_device(scene, tmp_path):
    """Two gloo ranks: the lattice shared over the ranks and all-gathered
    equals the serial build (LTE and non-LTE tiers); the sharded table
    forward and make_sharded_oe(lut=)'s normal equations equal the
    single-device build_forward_lut's (tests/test_lut.py's mesh cases)."""
    ref_lut = _tables(scene, "co2+co")[1]
    species = SPECIES["co2+co"]
    h = np.array([8e3, 14e3, 20e3, 35e3])
    tf = tstate.build_forward_lut(scene["atm"], ref_lut, species, MARS,
                                  tangent_heights_m=torch.as_tensor(h),
                                  n_sub=2)
    tx, tunravel = tstate.flatten_state(tstate.make_state(scene["atm"],
                                                          ["CO"]))
    g = lambda x: tf(tunravel(x))
    y, K = g(tx), torch.func.jacfwd(g)(tx)
    obs = (y.numpy() * 1.01 + 1e-9, np.full(y.shape, 0.002 * float(y.max())))
    sc = {"nu": scene["nu"], "lines": _numpy(scene["co2+co"][0]),
          "atm": {k: getattr(scene["atm"], k).numpy()
                  for k in ("z", "p", "T", "n")},
          "species": species, "h_t": h, "lattice": dict(
              LATTICE, vmr_self=[0.95, 7e-4])}
    sc["atm"]["vmr"] = {k: v.numpy() for k, v in scene["atm"].vmr.items()}
    got = cases.run(tmp_path, 2, cases.lut_mesh_case, sc, obs)
    serial_nlte = tlut.build_nlte_lut(
        torch.as_tensor(scene["nu"]), scene["co2+co"][1], 2,
        **sc["lattice"])
    w = 1.0 / obs[1] ** 2
    KtW = K.numpy().T * w[None, :]
    for r in got:
        # Each state is summed alone, in line order: the shares are the
        # serial build's states (the plain version's batched products
        # allow the last bit to differ).
        np.testing.assert_allclose(r["sigma"].numpy(), ref_lut.sigma.numpy(),
                                   rtol=1e-12, atol=0)
        for f in ("sigma_l", "sigma_u", "sigma_e"):
            np.testing.assert_allclose(r[f].numpy(),
                                       getattr(serial_nlte, f).numpy(),
                                       rtol=1e-12, atol=0)
        for shape in ((1, 1, 2), (2, 1, 1)):
            fwd, (F, H, gv), K_r = r[shape]
            _close(fwd, y.numpy(), 1e-12)
            _close(F, y.numpy(), 1e-12)
            np.testing.assert_allclose(H.numpy(), KtW @ K.numpy(), rtol=1e-9)
            np.testing.assert_allclose(gv.numpy(),
                                       KtW @ (obs[0] - y.numpy()), rtol=1e-9)
            _close(K_r, K.numpy(), 1e-12)


# The table's Jacobian against the direct one: max |J_lut - J_direct| <=
# LUT_JAC_REL max |J_direct|.  This test measured 0.0128 (float64, below);
# chip_smoke.py phase 6g holds the card's full-width float32 run to it.
LUT_JAC_REL = 0.05


def test_table_jacobian_near_the_direct_one(capsys):
    """examples/mars_limb.toml in small (128 points, 3 rays, 17 levels) on
    its default 21 x 25 lattice, float64: the table forward within the
    reference's LUT budget of the direct forward (max |dy| / max(y, 1e-3
    max y) < 0.05, tests/test_cli_config.py:224-226), and its temperature
    Jacobian within LUT_JAC_REL of max |J_direct|."""
    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch.ops.cuda_basis import PLAIN

    out = {}
    for lut in ("false", "true"):
        cfg = cli.load_config(SCENE, {
            "compute.dtype": "float64", "grid.n_points": "128",
            "geometry.tangent_heights_km": "10.0,40.0,70.0",
            "scene.n_levels": "17", "compute.use_lut": lut})
        prob = cli.retrieval_problem(cfg, cli.build_scene(cfg, CPU), PLAIN)
        out[lut] = (prob.fwd_flat(prob.x0).numpy(),
                    torch.func.jacfwd(prob.fwd_flat)(prob.x0).numpy())
    (yd, Jd), (yl, Jl) = out["false"], out["true"]
    y_rel = np.max(np.abs(yl - yd) / np.maximum(yd, 1e-3 * yd.max()))
    j_rel = np.abs(Jl - Jd).max() / np.abs(Jd).max()
    with capsys.disabled():
        print(f"\ntable vs direct (float64, CPU): radiance {y_rel:.4f} of "
              f"the LUT budget's scale, Jacobian {j_rel:.4f} of max |J|")
    assert y_rel < 0.05 and j_rel <= LUT_JAC_REL


def test_float32_table_takes_the_staged_grid(capsys):
    """A float32 table on the grid's float64-staged offset coordinates
    (``nu_off``, as the CLI passes them) stays within float32 roundoff of
    the float64 table in the Doppler regime, where the offsets of the
    rounded float32 grid (up to 3e-5 cm-1 at 660 cm-1, 1/20 of a Doppler
    width) move the line cores 100x more.  (The reference's float32 build
    takes the rounded grid, and its table forward of
    examples/mars_limb.toml misses the LUT budget on the highest rays.)"""
    from spectrobot_tpu_torch.data.synth import co2_15um_band as t_band
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist

    nu = np.linspace(660.0, 662.0, 2001)
    kw = dict(T_min=140.0, T_max=200.0, n_T=2, p_min=1e-3, p_max=1e-2,
              n_p=2, vmr_self=[0.95])
    stage = lambda dt: device_lines_from_linelist(
        t_band(j_max=12), [(2, 1)], dtype=dt, device=CPU)
    ref = tlut.build_lut(torch.as_tensor(nu), stage(torch.float64), 1,
                         **kw).sigma
    d32 = stage(torch.float32)
    nu32 = torch.as_tensor(nu, dtype=torch.float32)
    staged = torch.as_tensor(nu - float(d32.nu_ref), dtype=torch.float32)
    err = {name: float((tlut.build_lut(nu32, d32, 1, **kw, **extra).sigma
                        .double() - ref).abs().max() / ref.abs().max())
           for name, extra in (("staged", {"nu_off": staged}),
                               ("rounded", {}))}
    with capsys.disabled():
        print(f"\nfloat32 table vs float64, max |err| / max: on the staged "
              f"grid {err['staged']:.3e}, on the rounded grid "
              f"{err['rounded']:.3e}")
    assert err["staged"] <= 1e-3 and err["rounded"] >= 10 * err["staged"]
