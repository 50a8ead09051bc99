"""The collision-induced continuum of the PyTorch port (ops/cia.py) against
the JAX package, the ten tests of tests/test_cia.py: the n^2 path integral,
the staged continuum depth, the forward and its Jacobian with the
continuum, the HITRAN-format parser, the staging rules, the configuration,
and the sharded forward in gloo ranks, in float64 on the plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.forward import geometry as jgeo
from spectrobot_tpu.forward.limb import limb_radiance as j_limb_radiance
from spectrobot_tpu.ops import cia as j_cia
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu.retrieval import state as jstate
from spectrobot_tpu_torch import config as t_config
from spectrobot_tpu_torch import interop
from spectrobot_tpu_torch.data.atmosphere import MARS
from spectrobot_tpu_torch.forward import geometry as tgeo
from spectrobot_tpu_torch.forward.limb import limb_radiance
from spectrobot_tpu_torch.ops import cia as t_cia
from spectrobot_tpu_torch.ops.planck import planck_nu
from spectrobot_tpu_torch.retrieval import state as tstate

import torch_mesh_cases as cases
from test_cia import GENUINE_CIA

torch.set_num_threads(1)

CPU = torch.device("cpu")
# float64 parity with the reference: within TOL of max |ref|.
TOL = 1e-10


def _numpy(nt) -> dict:
    return {k: (v if v is None or isinstance(v, (bool, int))
                else np.asarray(v)) for k, v in nt._asdict().items()}


def _scene(n_lev=9):
    """tests/test_cia.py's scene in both packages: (jax (atm, dl, nu),
    port (atm, dl, nu))."""
    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=60e3)
    dl = j_stage(co2_15um_band(j_max=12), [(2, 1)], dtype=jnp.float64)
    nu = np.linspace(660.0, 674.0, 160)
    d = {k: np.asarray(getattr(atm, k)) for k in ("z", "p", "T", "n")}
    d["vmr"] = {k: np.asarray(v) for k, v in atm.vmr.items()}
    return ((atm, dl, jnp.asarray(nu)),
            (interop.atmosphere_from_numpy(d, device=CPU),
             interop.device_lines_from_numpy(_numpy(dl), device=CPU),
             torch.as_tensor(nu)))


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def _stage_both(nu, tables, species):
    return (j_cia.stage_cia(jnp.asarray(nu), tables, species,
                            dtype=jnp.float64),
            t_cia.stage_cia(np.asarray(nu), tables, species,
                            dtype=torch.float64, device=CPU))


def test_uu_air_uniform_slab_analytic():
    """int n^2 ds of a nadir path: the port's equals the reference's and
    the midpoint quadrature of the density profile."""
    (jatm, _, _), (tatm, _, _) = _scene(n_lev=17)
    cg = tgeo.nadir_path_cg(tatm, ["CO2"], torch.tensor([1.0],
                                                        dtype=torch.float64),
                            n_sub=64)
    ref_cg = jgeo.nadir_path_cg(jatm, ["CO2"], jnp.asarray([1.0]), n_sub=64)
    _close(cg.uu_air.numpy(), ref_cg.uu_air)
    uu = cg.uu_air[0].numpy() / tgeo.UU_SCALE
    z = tatm.z.numpy()
    ref = []
    for i in range(len(z) - 1):
        zz = z[i] + (np.arange(64) + 0.5) / 64 * (z[i + 1] - z[i])
        n = tatm.interp_n(torch.as_tensor(zz)).numpy()
        ref.append(np.sum(n ** 2) * (z[i + 1] - z[i]) / 64)
    np.testing.assert_allclose(uu, np.asarray(ref), rtol=1e-6)


def test_cia_dtau_positive_and_t_interpolated():
    (jatm, _, nu), (tatm, _, _) = _scene()
    h = np.array([10e3, 30e3])
    jcg = jgeo.limb_path_cg(jatm, ["CO2"], jnp.asarray(h), J_MARS, 4)
    tcg = tgeo.limb_path_cg(tatm, ["CO2"], torch.as_tensor(h), MARS, 4)
    tab = t_cia.demo_co2_cia(nu_min=600.0, nu_max=700.0)
    jc, tc = _stage_both(nu, [tab], ["CO2"])
    _close(tc.tables.numpy(), jc.tables, 1e-14)
    ref = np.asarray(j_cia.cia_dtau(jc, jcg))
    dtau = t_cia.cia_dtau(tc, tcg).numpy()
    assert dtau.shape == (2, tatm.n_lev - 1, nu.shape[0])
    assert np.isfinite(dtau).all() and (dtau >= 0).all()
    assert dtau[0].sum() > dtau[1].sum()
    _close(dtau, ref)


def _offband_table():
    return t_cia.cia_from_arrays("CO2", "CO2", np.linspace(600.0, 720.0, 64),
                                 np.array([100.0, 300.0]),
                                 np.full((2, 64), 2e-44))


def test_forward_with_cia_differs_and_is_thermalised():
    """Off the band (the 15 um band saturates the limb path) a strong
    continuum changes the radiance, never past the warmest Planck curve;
    the port's equals the reference's."""
    (jatm, jdl, _), (tatm, tdl, _) = _scene()
    nu = np.linspace(690.0, 700.0, 160)
    jcg = jgeo.limb_path_cg(jatm, ["CO2"], jnp.asarray([8e3]), J_MARS, 4)
    tcg = tgeo.limb_path_cg(tatm, ["CO2"], torch.tensor([8e3],
                                                        dtype=torch.float64),
                            MARS, 4)
    jc, tc = _stage_both(nu, [_offband_table()], ["CO2"])
    tnu = torch.as_tensor(nu)
    I0 = limb_radiance(tnu, tdl, tcg).numpy()[0]
    I1 = limb_radiance(tnu, tdl, tcg, cia=tc).numpy()[0]
    assert np.max(np.abs(I1 - I0)) > 10 * np.max(I0) * 1e-6
    B_max = float(planck_nu(tnu, float(tatm.T.max())).max())
    assert (I1 <= B_max * (1 + 1e-9)).all()
    _close(I1, np.asarray(j_limb_radiance(jnp.asarray(nu), jdl, jcg,
                                          cia=jc))[0])


def test_cia_jacobian_flows():
    """Jacobians see the continuum, through its T interpolation and the
    mixing-ratio weights of the VMR state: torch.func.jacfwd against
    jax.jacfwd, finite, and changed by the continuum."""
    (jatm, jdl, nu), (tatm, tdl, tnu) = _scene(n_lev=5)
    tab = t_cia.cia_from_arrays(
        "CO2", "CO2", np.linspace(600.0, 720.0, 64), np.array([100.0, 300.0]),
        np.stack([np.full(64, 3e-45), np.full(64, 1e-45)]))
    jc, tc = _stage_both(nu, [tab], ["CO2"])
    ths = np.array([8e3, 25e3])
    jf = jstate.build_forward(jatm, jdl, nu, ["CO2"], J_MARS,
                              tangent_heights_m=jnp.asarray(ths), cia=jc)
    jx0, junravel = jstate.flatten_state(jstate.make_state(jatm, ["CO2"]))
    J_ref = np.asarray(jax.jit(jax.jacfwd(lambda x: jf(junravel(x))))(jx0))

    def jac(cia):
        f = tstate.build_forward(tatm, tdl, tnu, ["CO2"], MARS,
                                 tangent_heights_m=torch.as_tensor(ths),
                                 cia=cia)
        x0, unravel = tstate.flatten_state(tstate.make_state(tatm, ["CO2"]))
        return torch.func.jacfwd(lambda x: f(unravel(x)))(x0).numpy()

    J, J0 = jac(tc), jac(None)
    assert np.isfinite(J).all()
    _close(J, J_ref)
    assert float(np.max(np.abs(J - J0))) > 0.0


def test_parse_cia_text_round_trip():
    tab = t_cia.demo_co2_cia(nu_min=600.0, nu_max=700.0)
    blocks = []
    for j, T in enumerate(tab.T_grid):
        n = tab.nu_grid.shape[0]
        blocks.append(f"CO2-CO2 {tab.nu_grid[0]:.4f} {tab.nu_grid[-1]:.4f} "
                      f"{n} {T:.1f} {tab.k[j].max():.3e}")
        blocks.extend(f"{x:.6f} {k:.6e}" for x, k in zip(tab.nu_grid,
                                                         tab.k[j]))
    text = "\n".join(blocks)
    parsed = t_cia.parse_cia_text(text, "CO2", "CO2")
    np.testing.assert_allclose(parsed.T_grid, tab.T_grid)
    np.testing.assert_allclose(parsed.k, tab.k, rtol=2e-6)
    ref = j_cia.parse_cia_text(text, "CO2", "CO2")
    for a, b in zip(parsed, ref):
        np.testing.assert_array_equal(a, b)


def test_stage_skips_absent_pairs():
    nu = np.linspace(600.0, 700.0, 32)
    tab = t_cia.demo_co2_cia()
    stage = lambda species: t_cia.stage_cia(nu, [tab], species, device=CPU)
    assert stage(["H2O"]) is None
    staged = stage(["H2O", "CO2"])
    assert staged.pair_a == (1,) and staged.pair_b == (1,)
    ref = j_cia.stage_cia(jnp.asarray(nu), [tab], ["H2O", "CO2"])
    assert staged.tables.dtype == torch.float32
    np.testing.assert_array_equal(staged.tables.numpy(),
                                  np.asarray(ref.tables))


def test_cli_cia_config(tmp_path):
    """[cia] parses in the port's configuration; the port's CLI stages the
    configured tables on the scene's grid as the reference's does."""
    from spectrobot_tpu import cli as j_cli
    from spectrobot_tpu_torch import cli

    p = tmp_path / "c.toml"
    p.write_text("[cia]\nenabled = true\ntables = [\"demo:co2\"]\n")
    cfg = t_config.load_config(str(p))
    assert cfg.cia.enabled and tuple(cfg.cia.tables) == ("demo:co2",)
    assert not t_config.load_config(
        str(p), overrides={"cia.enabled": "false"}).cia.enabled
    nu = np.linspace(600.0, 700.0, 64)
    got = cli._build_cia(cfg, torch.as_tensor(nu), ["CO2"], torch.float64,
                         CPU)
    ref = j_cli._build_cia(cfg, jnp.asarray(nu), ["CO2"], jnp.float64)
    _close(got.tables.numpy(), ref.tables, 0.0)


def test_cia_sharded_matches_single_device(tmp_path):
    """The continuum through the mesh: its tables cut by each rank's nu
    block, the sharded forward of a (2, 1, 2) mesh of gloo ranks equals
    the single-device continuum forward (and the reference's)."""
    (jatm, jdl, _), (tatm, tdl, _) = _scene()
    nu = np.linspace(660.0, 674.0, 256)
    h = np.array([8e3, 16e3, 24e3, 32e3])
    tcg = tgeo.limb_path_cg(tatm, ["CO2"], torch.as_tensor(h), MARS, 4)
    jcg = jgeo.limb_path_cg(jatm, ["CO2"], jnp.asarray(h), J_MARS, 4)
    tab = t_cia.demo_co2_cia(nu_min=600.0, nu_max=700.0)
    jc, tc = _stage_both(nu, [tab], ["CO2"])
    ref = limb_radiance(torch.as_tensor(nu), tdl, tcg, cia=tc).numpy()
    _close(ref, np.asarray(j_limb_radiance(jnp.asarray(nu), jdl, jcg,
                                           cia=jc)))
    sc = {"nu": nu, "lines": {k: v.numpy() for k, v in tdl._asdict().items()},
          "cg": {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                 for k, v in tcg._asdict().items()},
          "cutoff": 25.0, "T_surface": None, "emissivity": 1.0,
          "cia": {"tables": tc.tables.numpy(), "T_grid": tc.T_grid.numpy(),
                  "pair_a": tc.pair_a, "pair_b": tc.pair_b}}
    shape = (2, 1, 2)
    got = cases.run(tmp_path, 4, cases.sharded_case,
                    [("cia", shape, False, sc)])
    out = np.zeros_like(ref)
    for r in got:
        blk, coord, _ = r["cia"]
        rb, nb = (slice(coord[ax] * (n // shape[i]),
                        (coord[ax] + 1) * (n // shape[i]))
                  for ax, i, n in (("ray", 0, len(h)), ("nu", 2, len(nu))))
        out[rb, nb] = blk.numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-10,
                               atol=np.abs(ref).max() * 1e-12)


def test_genuine_cia_blocks_parse():
    t = t_cia.parse_cia_text(GENUINE_CIA, "N2", "N2")
    assert t.species_a == "N2" and t.species_b == "N2"
    np.testing.assert_allclose(t.T_grid, [200.0, 300.0])
    np.testing.assert_allclose(t.nu_grid, [10.0, 20.0, 30.0, 40.0, 50.0])
    np.testing.assert_allclose(
        t.k[0], [1.0e-46, 3.0e-46, 5.0e-46, 3.5e-46, 1.5e-46])
    assert t.k[1][0] == 0.0
    np.testing.assert_allclose(
        t.k[1][1], np.interp(20.0, [12.0, 22.0], [0.8e-46, 2.4e-46]))
    assert np.all(t.k >= 0)
    for a, b in zip(t, j_cia.parse_cia_text(GENUINE_CIA, "N2", "N2")):
        np.testing.assert_array_equal(a, b)


def test_cia_malformed_header_rejected():
    bad = GENUINE_CIA.replace("     5  200.0", "  five  200.0", 1)
    with pytest.raises(ValueError):
        t_cia.parse_cia_text(bad, "N2", "N2")
