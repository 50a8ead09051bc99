"""The port's copies of the reference's jax-free host modules behave as the
originals: the TOML schema parses to the same values, the partition sums,
the synthetic line lists, an Observation round trip, the host half of the
non-LTE module and the continuum tables' host functions agree."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from spectrobot_tpu import config as j_config
from spectrobot_tpu.data import synth as j_synth
from spectrobot_tpu.data import tips as j_tips
from spectrobot_tpu.retrieval.obs import Observation as JObservation
from spectrobot_tpu_torch import config as t_config
from spectrobot_tpu_torch.data import synth as t_synth
from spectrobot_tpu_torch.data import tips as t_tips
from spectrobot_tpu_torch.retrieval.obs import Observation as TObservation
from test_torch_cli import TINY_TOML

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(os.path.basename(p) for p in
                  glob.glob(os.path.join(REPO, "examples", "*.toml")))


def _same_line_lists(a, b):
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if fa[k] is None:
            assert fb[k] is None, k
        else:
            np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)


def _check_config(path):
    overrides = {"grid.n_points": "512", "geometry.mode": "nadir"}
    for ov in ({}, overrides):
        ref = j_config.load_config(path, ov)
        got = t_config.load_config(path, ov)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def _check_tips():
    T = np.linspace(25.0, 1450.0, 173)
    species = sorted(j_tips._SPECIES)
    assert sorted(t_tips._SPECIES) == species
    for mol, iso in species:
        np.testing.assert_array_equal(t_tips.q_of_T(mol, iso, T),
                                      j_tips.q_of_T(mol, iso, T))
    np.testing.assert_array_equal(t_tips.T_GRID, j_tips.T_GRID)


def _check_synth():
    _same_line_lists(t_synth.random_lines(300, 600.0, 750.0, seed=3),
                     j_synth.random_lines(300, 600.0, 750.0, seed=3))
    _same_line_lists(t_synth.co2_15um_band(j_max=80),
                     j_synth.co2_15um_band(j_max=80))


def _check_nlte(tmp_path):
    """The host half of data/nlte.py: registry, matching and the t_vib
    profiles (LTE, the demo pumping, an .npz round trip)."""
    from spectrobot_tpu.data import nlte as j_nlte
    from spectrobot_tpu_torch.data import nlte as t_nlte
    lists = {}
    for mod, syn in ((j_nlte, j_synth), (t_nlte, t_synth)):
        ll = syn.co2_43um_band(j_max=20).concat(
            syn.co2_43um_hot_band(j_max=12)).concat(syn.co2_15um_band(8))
        reg = mod.registry_from_linelist(ll)
        lists[mod] = (mod.match_lines_to_levels(ll, reg), reg)
    (jll, jreg), (tll, treg) = lists[j_nlte], lists[t_nlte]
    _same_line_lists(tll, jll)
    assert treg.keys == jreg.keys and treg.energies_cm1 == jreg.energies_cm1
    assert treg.lookup(2, 1, " 0001 ") == jreg.lookup(2, 1, "0001") >= 0
    z_mid = np.linspace(2e3, 88e3, 12)
    T_lay = np.linspace(210.0, 140.0, 12)
    np.testing.assert_array_equal(t_nlte.lte_t_vib(treg, T_lay),
                                  j_nlte.lte_t_vib(jreg, T_lay))
    np.testing.assert_array_equal(t_nlte.demo_pump_t_vib(treg, z_mid, T_lay),
                                  j_nlte.demo_pump_t_vib(jreg, z_mid, T_lay))
    keys = [f"2:1:{q}" for q in ("0001", "0111")]
    t_vib = np.stack([np.linspace(200.0, 260.0, 7)] * 2)
    z_file = np.linspace(0.0, 100e3, 7)
    for writer, reader, r in ((j_nlte, t_nlte, treg), (t_nlte, j_nlte, jreg)):
        path = str(tmp_path / f"tvib_{writer.__name__[:16]}.npz")
        writer.save_t_vib_npz(path, z_file, keys, t_vib)
        np.testing.assert_array_equal(
            reader.t_vib_from_npz(r, path, z_mid, T_lay),
            j_nlte.t_vib_from_npz(jreg, path, z_mid, T_lay))
    with pytest.raises(ValueError, match="no key matches"):
        path = str(tmp_path / "other.npz")
        t_nlte.save_t_vib_npz(path, z_file, ["5:1:1"], t_vib[:1])
        t_nlte.t_vib_from_npz(treg, path, z_mid, T_lay)


def _check_cia():
    """The host functions of ops/cia.py: the demo table, the array
    constructor and the HITRAN-format parser."""
    from spectrobot_tpu.ops import cia as j_cia
    from spectrobot_tpu_torch.ops import cia as t_cia
    for args in ((), (600.0, 700.0)):
        for a, b in zip(t_cia.demo_co2_cia(*args), j_cia.demo_co2_cia(*args)):
            np.testing.assert_array_equal(a, b)
    tab = t_cia.cia_from_arrays("N2", "CH4", [1.0, 2.0, 3.0], [100.0, 200.0],
                                [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    ref = j_cia.cia_from_arrays("N2", "CH4", [1.0, 2.0, 3.0], [100.0, 200.0],
                                [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    for a, b in zip(tab, ref):
        np.testing.assert_array_equal(a, b)
    text = "\n".join(
        [f"X-Y 10.0 30.0 3 {T} 1e-45\n" + "\n".join(
            f"{10.0 + 10 * i + off} {k * (i + 1)}e-46" for i in range(3))
         for T, off, k in ((300.0, 1.0, 2), (150.0, 0.0, 3))])
    for a, b in zip(t_cia.parse_cia_text(text, "X", "Y"),
                    j_cia.parse_cia_text(text, "X", "Y")):
        np.testing.assert_array_equal(a, b)


def _check_obs(tmp_path):
    rng = np.random.default_rng(0)
    y = rng.uniform(1.0, 2.0, (3, 40))
    chans = np.linspace(660.0, 675.0, 40)
    ths = np.array([8e3, 25e3, 45e3])
    obs = {cls: cls.synthesize(y, chans, 0.01, seed=4, tangent_heights_m=ths)
           .with_windows([(661.0, 670.0)]) for cls in (JObservation,
                                                       TObservation)}
    for cls, o in obs.items():
        for k in ("y", "sigma", "mask", "nu_channels"):
            np.testing.assert_array_equal(getattr(o, k),
                                          getattr(obs[JObservation], k))
    # Each package reads what the other wrote, as .npz and as a text table.
    for writer, reader in ((JObservation, TObservation),
                           (TObservation, JObservation)):
        for ext in (".npz", ".txt"):
            path = str(tmp_path / f"obs_{writer.__module__[:16]}{ext}")
            (obs[writer].save_npz if ext == ".npz"
             else obs[writer].save_table)(path)
            back = reader.load(path)
            for a, b in zip(back.flattened(), obs[writer].flattened()):
                np.testing.assert_allclose(a, b, rtol=1e-8)


@pytest.mark.parametrize("case", [f"config:{n}" for n in EXAMPLES]
                         + ["config:tiny", "config:defaults", "tips",
                            "synth", "obs", "nlte", "cia"])
def test_copied_host_module_matches_original(case, tmp_path):
    if case == "config:tiny":
        path = tmp_path / "tiny.toml"
        path.write_text(TINY_TOML)
        _check_config(str(path))
    elif case == "config:defaults":
        _check_config(None)
    elif case.startswith("config:"):
        _check_config(os.path.join(REPO, "examples", case.split(":", 1)[1]))
    elif case == "tips":
        _check_tips()
    elif case == "synth":
        _check_synth()
    elif case == "nlte":
        _check_nlte(tmp_path)
    elif case == "cia":
        _check_cia()
    else:
        _check_obs(tmp_path)
