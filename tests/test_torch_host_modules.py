"""The port's copies of the reference's jax-free host modules behave as the
originals: the TOML schema parses to the same values, the partition sums,
the synthetic line lists and an Observation round trip agree."""

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
                            "synth", "obs"])
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
    else:
        _check_obs(tmp_path)
