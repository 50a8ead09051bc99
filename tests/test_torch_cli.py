"""The whole forward slice: ``python -m spectrobot_tpu_torch forward`` on a
tiny scene (CPU, the plain line sum) against the JAX CLI's forward on the
same TOML, compared through forward.npz."""

import os

import numpy as np
import pytest

from spectrobot_tpu.config import load_config
from spectrobot_tpu.spectra import Spectrum
from spectrobot_tpu_torch import cli

TINY_TOML = """\
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 256
[scene]
n_levels = 7
z_top_m = 60e3
[geometry]
tangent_heights_km = [8.0, 25.0]
n_sub = 2
[instrument]
enabled = true
fwhm_cm1 = 0.4
n_channels = 32
[compute]
chunk = 128
"""


@pytest.fixture(scope="module")
def tiny_toml(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.toml"
    path.write_text(TINY_TOML)
    return str(path)


def _jax_forward(toml, overrides, out_dir):
    from spectrobot_tpu.cli import cmd_forward
    cfg = load_config(toml, {**overrides, "run.output_dir": str(out_dir)})
    return np.load(cmd_forward(cfg)["output"])


def _torch_forward(toml, overrides, out_dir):
    argv = ["forward", toml, "--device", "cpu", "-o",
            f"run.output_dir={out_dir}"]
    for k, v in overrides.items():
        argv += ["-o", f"{k}={v}"]
    assert cli.main(argv) == 0
    return np.load(os.path.join(out_dir, "forward.npz"))


@pytest.mark.parametrize("overrides,rtol,atol_rel", [
    ({}, 5e-5, 1e-5),
    ({"compute.dtype": "float64"}, 1e-9, 0.0),
    ({"geometry.mode": "nadir", "geometry.sec_theta": "1.0,1.4"}, 5e-5,
     1e-5),
])
def test_forward_matches_jax_cli(tiny_toml, tmp_path, overrides, rtol,
                                 atol_rel):
    ref = _jax_forward(tiny_toml, overrides, tmp_path / "jax")
    got = _torch_forward(tiny_toml, overrides, tmp_path / "torch")
    assert sorted(got.files) == sorted(ref.files)
    for key in ("kind", "units"):
        assert str(got[key]) == str(ref[key])
    np.testing.assert_array_equal(got["nu"], ref["nu"])
    np.testing.assert_array_equal(got["nu_fine"], ref["nu_fine"])
    r, g = ref["values"], got["values"]
    assert g.shape == r.shape and np.all(np.isfinite(g)) and np.all(g >= 0)
    np.testing.assert_allclose(g, r, rtol=rtol, atol=atol_rel * r.max())
    # The reference's reader takes the port's output.
    sp = Spectrum.load_npz(os.path.join(tmp_path / "torch", "forward.npz"))
    assert sp.kind == "radiance" and sp.values.shape == r.shape


@pytest.mark.parametrize("override,key", [
    ("nlte.enabled=true", "nlte.enabled"),
    ("cia.enabled=true", "cia.enabled"),
    ("lines.chi=co2_mars", "lines.chi"),
    ("instrument.fov_fwhm_km=3.0", "instrument.fov_fwhm_km"),
    ("compute.use_lut=true", "compute.use_lut"),
    ("compute.mesh_nu=2", "compute.mesh_nu"),
    ("run.save_optics=true", "run.save_optics"),
    ("scene.atmosphere=mars_zonal", "scene.atmosphere"),
])
def test_unported_key_raises_naming_it(tiny_toml, tmp_path, override, key):
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        cli.main(["forward", tiny_toml, "--device", "cpu", "-o", override,
                  "-o", f"run.output_dir={tmp_path}"])
    assert not os.path.exists(os.path.join(tmp_path, "forward.npz"))


def test_retrieve_not_ported(tiny_toml):
    with pytest.raises(NotImplementedError, match="retrieve"):
        cli.main(["retrieve", tiny_toml, "--device", "cpu"])


def test_cuda_device_rule(tiny_toml):
    """--device cuda never falls back: without a GPU it raises; the engine
    rule on CUDA takes only the float32 kernel configuration, while on the
    CPU the same wrapper runs its plain version in any configuration."""
    import torch

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = load_config(tiny_toml)
    assert cli.select_accumulate(cfg, cuda) is cli.accumulate_batch
    for override in ({}, {"compute.use_pallas": "false"},
                     {"compute.dtype": "float64"}):
        assert cli.select_accumulate(load_config(tiny_toml, override),
                                     cpu) is cli.accumulate_batch
    for override, key in (({"compute.use_pallas": "false"},
                           "compute.use_pallas"),
                          ({"compute.dtype": "float64"}, "compute.dtype")):
        with pytest.raises(NotImplementedError, match=key):
            cli.select_accumulate(load_config(tiny_toml, override), cuda)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["forward", tiny_toml])
