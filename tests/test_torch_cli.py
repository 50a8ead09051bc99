"""The whole CLI: ``python -m spectrobot_tpu_torch forward`` and
``retrieve`` on a tiny scene (CPU, the plain line sum and its tangent)
against the JAX CLI on the same TOML, compared through forward.npz and
retrieval.npz."""

import json
import os

import numpy as np
import pytest
import torch

from spectrobot_tpu.config import load_config
from spectrobot_tpu.spectra import Spectrum
from spectrobot_tpu_torch import cli

# These tests run tiny tensors: torch's intra-op threads would only
# contend (and spin-wait) with the other test workers for the cores.
torch.set_num_threads(1)

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
    # The same files (forward.npz and the forward.png plot), the same keys.
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(
        os.listdir(tmp_path / "jax"))
    assert "forward.png" in os.listdir(tmp_path / "torch")
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
    # The mesh keys and lines.chi are ported: a mesh of more ranks than the
    # run has (one, here) raises a ValueError naming them, and so does chi
    # beyond the cutoff its single-segment form is valid to.
    ported = key.startswith("compute.mesh_") or key == "lines.chi"
    err = ValueError if ported else NotImplementedError
    extra = ["-o", "compute.cutoff_cm1=40"] if key == "lines.chi" else []
    with pytest.raises(err, match=key.replace(".", r"\.")):
        cli.main(["forward", tiny_toml, "--device", "cpu", "-o", override,
                  "-o", f"run.output_dir={tmp_path}", *extra])
    assert not os.path.exists(os.path.join(tmp_path, "forward.npz"))


@pytest.mark.parametrize("override,item", [
    ({"nlte.enabled": "true"}, 1),
    ({"cia.enabled": "true"}, 3),
    ({"instrument.fov_fwhm_km": "3.0"}, 4),
    ({"compute.use_lut": "true"}, 5),
    ({"scene.atmosphere": "mars_zonal"}, 6),
    ({"compute.variant": "weideman"}, 7),
    ({"run.save_optics": "true"}, 8),
])
def test_each_refusal_names_its_roadmap_item(tiny_toml, override, item):
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP Queue 1 item {item}\b"):
        cli.check_ported(load_config(tiny_toml, override))


def test_sharded_lut_refusal_names_its_roadmap_item():
    from spectrobot_tpu_torch.parallel.oe import make_sharded_oe
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP Queue 1 item 5\b"):
        make_sharded_oe(None, None, None, None, [], None, state_template={},
                        lut=object())


def _jax_retrieve(toml, overrides, out_dir, x64=True):
    import jax

    from spectrobot_tpu.cli import cmd_retrieve
    cfg = load_config(toml, {**overrides, "run.output_dir": str(out_dir)})
    # The reference's float32 CLI runs with x64 off, as on its chip.
    with jax.enable_x64(x64):
        result = cmd_retrieve(cfg)
    return result, np.load(result["output"])


def _torch_retrieve(toml, overrides, out_dir, capsys):
    argv = ["retrieve", toml, "--device", "cpu", "-o",
            f"run.output_dir={out_dir}"]
    for k, v in overrides.items():
        argv += ["-o", f"{k}={v}"]
    capsys.readouterr()
    assert cli.main(argv) == 0
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    status = [ln for ln in err.splitlines() if ln.startswith("retrieve: ")]
    return result, np.load(os.path.join(out_dir, "retrieval.npz")), status


def test_retrieve_matches_jax_cli_f64(tiny_toml, tmp_path, capsys):
    """``retrieve`` is ported: the self-test retrieval of the tiny scene in
    float64 (plain line sum and its analytic tangent) takes the reference
    CLI's LM path, and retrieval.npz holds the same keys and values."""
    ov = {"compute.dtype": "float64"}
    ref_res, ref = _jax_retrieve(tiny_toml, ov, tmp_path / "jax")
    got_res, got, status = _torch_retrieve(tiny_toml, ov, tmp_path / "torch",
                                           capsys)
    assert sorted(got.files) == sorted(ref.files)
    for key in ("n_iter", "converged", "stop_reason"):
        assert got[key] == ref[key], key
    assert got_res == {**ref_res, "output": got_res["output"],
                       "chi2": got_res["chi2"]}
    assert got_res["converged"] and got_res["n_iter"] >= 2
    np.testing.assert_allclose(got["chi2"], ref["chi2"], rtol=1e-6)
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-6)
    for key in ("y_obs", "noise", "nu", "channels_cm1"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-12)
    for key in ("values", "S_hat", "A_kernel"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5,
                                   atol=1e-8 * np.abs(ref[key]).max())
    assert status == [f"retrieve: {got_res['status']}; "
                      f"n_iter={got_res['n_iter']} chi2="
                      f"{got_res['chi2']:.4g} -> {got_res['output']}"]
    log = [json.loads(ln) for ln in
           open(os.path.join(tmp_path / "torch", "run.jsonl"))]
    assert [r["iteration"] for r in log] == list(range(int(got["n_iter"])))


def test_retrieve_float32_matches_jax_cli(tiny_toml, tmp_path, capsys):
    """The float32 CLI retrieval (the card's dtype, LM algebra in float64):
    both packages converge to within a tenth of the posterior sigma."""
    ov = {"compute.dtype": "float32"}
    _, ref = _jax_retrieve(tiny_toml, ov, tmp_path / "jax", x64=False)
    res, got, _ = _torch_retrieve(tiny_toml, ov, tmp_path / "torch", capsys)
    assert res["converged"] and bool(ref["converged"])
    assert np.isfinite(got["values"]).all() and np.isfinite(got["x"]).all()
    sigma = np.sqrt(np.diag(ref["S_hat"]))
    assert np.max(np.abs(got["x"] - ref["x"]) / sigma) <= 0.1


def test_info_reports_the_reference_keys():
    """``info`` reports the native parser and the molecule registry as the
    reference's does, with the same values."""
    from spectrobot_tpu.cli import cmd_info as jax_info
    got, ref = cli.cmd_info(), jax_info()
    for key in ("native_parser_built", "molecules_registered",
                "isotopologues_registered"):
        assert got[key] == ref[key], key
    assert got["molecules_registered"] == 55
    assert got["isotopologues_registered"] == 145


def test_cuda_device_rule(tiny_toml):
    """--device cuda never falls back: without a GPU it raises; the engine
    rule on CUDA takes only the float32 kernel configuration, while on the
    CPU the same wrappers run their plain versions in any configuration."""
    import torch

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = load_config(tiny_toml)
    assert cli.select_engine(cfg, cuda) is cli.KERNELS
    for override in ({}, {"compute.use_pallas": "false"},
                     {"compute.dtype": "float64"}):
        assert cli.select_engine(load_config(tiny_toml, override),
                                 cpu) is cli.KERNELS
    for override, key in (({"compute.use_pallas": "false"},
                           "compute.use_pallas"),
                          ({"compute.dtype": "float64"}, "compute.dtype")):
        with pytest.raises(NotImplementedError, match=key):
            cli.select_engine(load_config(tiny_toml, override), cuda)
    if not torch.cuda.is_available():
        for cmd in ("forward", "retrieve"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main([cmd, tiny_toml])


# The retrieval paths beyond one species' temperature, each a float64 CPU
# run of both CLIs on a small scene.  Scratch runs of these cases agreed to
# 4.7e-15 of max |x| or better; the tolerance, X_TOL of max |x| (and of max
# radiance for the forward), leaves room for summation order only.
X_TOL = 1e-10
RETRIEVAL_CASES = {
    # config 5 in small (examples/multispecies_retrieval.toml): CO2 + CO
    # lines in the 4-5 um window, T + ln VMR(CO)
    "co2_co_vmr": """\
[grid]
nu_min = 2080.0
nu_max = 2380.0
n_points = 256
[scene]
n_levels = 7
z_top_m = 60e3
species = ["CO2", "CO"]
[lines]
source = "synthetic:co2_43um,co_fundamental"
[geometry]
tangent_heights_km = [8.0, 25.0]
n_sub = 2
[instrument]
enabled = true
fwhm_cm1 = 4.0
n_channels = 32
[retrieval]
retrieve_vmr = ["CO"]
max_iter = 6
""",
    # nadir with the chi wing correction, a grey surface and ln VMR(CO2)
    "nadir_chi_vmr": TINY_TOML.replace("[geometry]", """\
[lines]
chi = "co2_mars"
[geometry]
mode = "nadir"
sec_theta = [1.0, 1.4]
emissivity = 0.9""").replace("[compute]", """\
[retrieval]
retrieve_vmr = ["CO2"]
max_iter = 8
[compute]"""),
    # T and ln VMR(CO2) on 3 altitude nodes
    "nodes_vmr": TINY_TOML.replace("[compute]", """\
[retrieval]
retrieve_vmr = ["CO2"]
n_nodes = 3
max_iter = 6
[compute]"""),
    # a line list file whose CO2 lines are two isotopologues (626 and 636)
    "two_isotopologues": TINY_TOML.replace("[geometry]", """\
[lines]
source = "{npz}"
[geometry]""").replace("[compute]", """\
[retrieval]
max_iter = 6
[compute]"""),
}


@pytest.mark.parametrize("case", sorted(RETRIEVAL_CASES))
def test_retrieval_paths_match_jax_cli_f64(tmp_path, capsys, case):
    """Each case: forward.npz and retrieval.npz of both CLIs in float64,
    the same iterations and convergence, radiances and retrieved state
    within X_TOL of their maxima."""
    from spectrobot_tpu.data.hitran import LineList
    from spectrobot_tpu.data.synth import co2_15um_band

    text = RETRIEVAL_CASES[case]
    if "{npz}" in text:
        ll = co2_15um_band()
        iso = ll.iso_id.copy()
        iso[1::2] = 2
        ll = LineList(**{**{f: getattr(ll, f) for f in ll.__dataclass_fields__},
                         "iso_id": iso})
        path = tmp_path / "lines.npz"
        ll.save_npz(str(path))
        assert set(LineList.load_npz(str(path)).iso_id.tolist()) == {1, 2}
        text = text.replace("{npz}", str(path))
    toml = tmp_path / f"{case}.toml"
    toml.write_text(text)
    ov = {"compute.dtype": "float64"}
    ref_f = _jax_forward(str(toml), ov, tmp_path / "jax_f")
    got_f = _torch_forward(str(toml), ov, tmp_path / "torch_f")
    r = ref_f["values"]
    np.testing.assert_allclose(got_f["values"], r, rtol=0,
                               atol=X_TOL * np.abs(r).max())
    _, ref = _jax_retrieve(str(toml), ov, tmp_path / "jax")
    res, got, _ = _torch_retrieve(str(toml), ov, tmp_path / "torch", capsys)
    assert res["converged"] and bool(ref["converged"])
    for key in ("n_iter", "converged", "stop_reason"):
        assert got[key] == ref[key], key
    assert got["x"].shape == ref["x"].shape
    np.testing.assert_allclose(got["x"], ref["x"], rtol=0,
                               atol=X_TOL * np.abs(ref["x"]).max())
