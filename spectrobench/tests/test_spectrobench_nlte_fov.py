"""The non-LTE, field-of-view scene (``configs/mars43_nlte_fov.toml``) and
its plain reference (``reference/nlte_fov.py``) on the CPU at a small size
(the port's kernels run their plain versions there):

- the port's forward and ``jacfwd`` along a seeded direction against the
  reference's ``forward`` and ``jvp`` at three seeded states;
- the reference equal to ``physics.py`` with the pump off and one ray of
  the ladder a field of view;
- the catalog: the port's own bands, their quanta through ``lines.npz``,
  and the levels the port matches them to;
- what ``covers`` refuses, and that the reference imports nothing of the
  port;
- the cell's run: sound, it is correct; with each planted fault (LTE
  weights, the field of view skipped, the vibrational temperatures taken
  from the retrieved state, not prescribed, and a retrieval that stops at
  its prior), it is not."""

import ast
import time

import numpy as np
import pytest
import torch

from spectrobench import manifest, run
from spectrobench.inputs import make_inputs, read_config, rng
from spectrobench.reference import nlte_fov, physics

CELL = "mars43_nlte_fov.retrieve"
# The cell's configuration cut to a size a CPU test holds: 256 points over
# its band, 8 levels, 4 observed rays on a ladder of 6, 32 channels.
SMALL_NLTE = {"grid.n_points": "256", "scene.n_levels": "8",
              "geometry.tangent_heights_km": "10,20,30,40",
              "instrument.n_channels": "32", "instrument.fov_n_fine": "6"}


def _inputs(tmp_path, overrides=SMALL_NLTE, seed=17):
    man = manifest.load()
    return make_inputs(manifest.config_path(man, "mars43_nlte_fov"),
                       manifest.traffic("retrieve"), seed, str(tmp_path),
                       overrides)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    inp = _inputs(tmp_path_factory.mktemp("in"))
    from spectrobot_tpu_torch import cli
    scene = cli.build_scene(inp.cfg, torch.device("cpu"))
    return inp, cli, scene


def _gap(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("k", range(3))
def test_forward_and_jacobian_match_the_port(small, k):
    """At three seeded states (the prior plus a smooth perturbation of up
    to 10 K), within 1e-5 of the largest value: float32 sums of a few
    hundred terms agree to some 1e-7, and a TF32 product (the control)
    moves them by 1e-4 or more."""
    inp, cli, scene = small
    prob = cli.retrieval_problem(inp.cfg, scene)
    g = rng(100 + k, 1)
    x = torch.as_tensor(inp.pool[k]["T"], dtype=prob.x0.dtype)
    v = g.standard_normal(x.shape[0])
    y = prob.fwd_flat(x).double().numpy()
    K = torch.func.jacfwd(prob.fwd_flat)(x).double().numpy()
    vmr = inp.scene.atm["vmr_CO2"]
    ref, dref = (a.double().numpy() for a in nlte_fov.jvp(
        inp.scene, x.double().numpy(), vmr, v, np.zeros_like(vmr),
        "float32", "cpu", torch.float32))
    assert y.shape == ref.shape == (4 * 32,)
    assert _gap(y, ref) < 1e-5
    assert _gap(K @ v, dref) < 1e-5
    ctrl, dctrl = (a.double().numpy() for a in nlte_fov.jvp(
        inp.scene, x.double().numpy(), vmr, v, np.zeros_like(vmr), "tf32",
        "cpu", torch.float32))
    assert _gap(ctrl, ref) > 1e-4 and _gap(dctrl, dref) > 1e-4


def test_without_pump_and_field_of_view_it_is_physics():
    """With [nlte] off and no field of view, or a field of view that is the
    identity on the observed rays, the reference gives physics.py's
    spectra and derivatives: the weights are 1, the emission depth is the
    absorption depth."""
    from spectrobot_tpu_torch.config import load_config
    path = manifest.config_path(manifest.load(), "mars43_nlte_fov")
    cfg = load_config(str(path), {**SMALL_NLTE, "nlte.enabled": "false",
                                  "instrument.fov_fwhm_km": "0"})
    lines, atm = nlte_fov.inputs(cfg, read_config(path)["bench"])
    mine = nlte_fov.configured_scene(cfg, lines, atm)
    theirs = physics.configured_scene(cfg, lines, atm)
    assert mine.t_vib is None and mine.V is None
    ident = mine._replace(V=np.eye(mine.h_t.shape[0]))
    z = theirs.atm["z"]
    T = theirs.atm["T"] + 3.0 * np.sin(z / 2e4)
    vmr = theirs.atm["vmr_CO2"]
    dT = np.linspace(-1.0, 1.0, T.shape[0])
    want = physics.jvp(theirs, T, vmr, dT, np.zeros_like(vmr))
    for scene in (mine, ident):
        got = nlte_fov.jvp(scene, T, vmr, dT, np.zeros_like(vmr))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0.0, atol=0.0)


def test_the_catalog_is_the_port_s_bands_with_their_quanta(small, tmp_path):
    """The recipe's columns are data/synth.py's two bands, and written to
    ``lines.npz`` (as the harness writes it) they reach the program with
    their quanta: every line matched to the levels the reference
    finds, at the same energies, and every line's upper level pumped."""
    from spectrobot_tpu_torch.data import synth
    from spectrobot_tpu_torch.data.hitran import LineList
    from spectrobot_tpu_torch.data.nlte import (
        match_lines_to_levels, registry_from_linelist)

    inp, cli, scene = small
    ours = nlte_fov.co2_43um_bands(inp.bench["lines"]["j_max"])
    port = synth.co2_43um_band(60).concat(synth.co2_43um_hot_band(50))
    order = np.argsort(ours["nu0"], kind="stable")
    assert len(port) == order.shape[0] == 222
    for k in ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
              "delta_air", "mass_amu", "mol_id", "iso_id",
              "quanta_global_u", "quanta_global_l"):
        np.testing.assert_array_equal(ours[k][order], getattr(port, k), k)

    path = tmp_path / "lines.npz"
    np.savez(path, **ours)
    ll = LineList.load_npz(str(path))
    np.testing.assert_array_equal(ll.quanta_global_u,
                                  port.quanta_global_u)
    np.testing.assert_array_equal(ll.quanta_global_l,
                                  port.quanta_global_l)
    reg = registry_from_linelist(ll)
    match_lines_to_levels(ll, reg)
    e = np.asarray(reg.energies_cm1)
    ref = inp.scene
    np.testing.assert_array_equal(ref.lines["nu0"], ll.nu0)
    np.testing.assert_array_equal(e[ll.level_upper], ref.e_level[ref.lev_u])
    np.testing.assert_array_equal(e[ll.level_lower], ref.e_level[ref.lev_l])
    assert cli.SCENE_COUNTS == {"fov_fine_rays": 6, "nlte_pumped_lines": 222}
    assert scene.nlte is not None and bool(
        (scene.lines.level_upper >= 0).all())


@pytest.mark.parametrize("key,value", [
    ("cia.enabled", "true"), ("lines.chi", "co2_mars"),
    ("nlte.enabled", "false"), ("instrument.fov_fwhm_km", "0"),
    ("nlte.t_vib", ""), ("compute.use_lut", "true")])
def test_covers_refuses_what_it_does_not_compute(tmp_path, key, value):
    with pytest.raises(ValueError, match="does not cover"):
        _inputs(tmp_path, {**SMALL_NLTE, key: value})


def test_the_reference_imports_nothing_of_the_port():
    for mod in (nlte_fov, physics):
        tree = ast.parse(open(mod.__file__).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & {"jax", "spectrobot_tpu",
                                    "spectrobot_tpu_torch"}, tops


# ---------------------------------------------------------------------------
# Planted faults, each under the timed path (``set_attr``: monkeypatch's
# ``setattr``, or ``setattr`` itself for a run outside the tests).
# ---------------------------------------------------------------------------


def plant_lte_weights(set_attr) -> None:
    """The non-LTE weights forced to 1: the populations at LTE."""
    from spectrobot_tpu_torch.forward import limb
    real = limb.layer_weights

    def lte(nlte, lines, T_air):
        return tuple(torch.ones_like(w) for w in real(nlte, lines, T_air))
    set_attr(limb, "layer_weights", lte)


def plant_fov_skipped(set_attr) -> None:
    """The field of view skipped: the forward runs the observed rays
    alone, no smear."""
    from spectrobot_tpu_torch import cli

    def pencil(cfg, dtype, device):
        h = np.asarray(cfg.geometry.tangent_heights_km, np.float64) * 1e3
        return torch.as_tensor(h, dtype=dtype, device=device), None
    set_attr(cli, "_build_fov", pencil)


def plant_t_vib_from_state(set_attr) -> None:
    """The vibrational temperatures recomputed from the retrieved state:
    each level's prescribed ratio to the kinetic profile (the pump's ramp,
    or 1) applied to each state's own kinetic temperature, where they are
    prescribed once from the configured atmosphere."""
    from spectrobot_tpu_torch.data import nlte as nlte_mod
    from spectrobot_tpu_torch.forward import limb

    def following(nlte, lines, T_air):
        # Level 0, the ground state, is not pumped: its row is T_kin.
        ramp = (nlte.t_vib / nlte.t_vib[:1]).T.to(T_air.dtype)
        return nlte_mod._line_weights(nlte.e_level, ramp * T_air[..., None],
                                      lines, T_air)
    set_attr(limb, "layer_weights", following)


def plant_step_unchanged(set_attr) -> None:
    """The LM step computed as ever, its state returned unchanged
    (``calibrate.py``'s plant): the retrieval stops at its prior."""
    from spectrobench.calibrate import plant_step_unchanged as plant
    from spectrobot_tpu_torch.retrieval import oe
    set_attr(oe, "_lm_solve", oe._lm_solve)
    plant()


# Each fault and the number of the comparison it must pass the limit of.
FAULTS = {"lte_weights": (plant_lte_weights, "fit_gap"),
          "fov_skipped": (plant_fov_skipped, "fit_gap"),
          "t_vib_from_state": (plant_t_vib_from_state, "fit_gap"),
          "step_unchanged": (plant_step_unchanged, "fit_chi2")}


def _run(max_units=1):
    man = manifest.load()
    rec = run.run_cell(CELL, 11, 0.1, False, torch.device("cpu"),
                       time.time(), man, overrides=SMALL_NLTE,
                       max_units=max_units)
    return run.result_line(rec, man, False)


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"] is True and out["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    plant, number = FAULTS[fault]
    plant(monkeypatch.setattr)
    out = _run()
    assert out["correct"] is False
    over = [k for k, v in out["checks"].items() if v["value"] > v["limit"]]
    assert number in over, out["checks"]
