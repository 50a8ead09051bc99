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


# Acceptance config 3 in small: the tiny scene moved to the 4.3 um band
# (fundamental and hot band) with the demo nu3 pumping aloft.
CONFIG3 = {"grid.nu_min": "2320.0", "grid.nu_max": "2360.0",
           "scene.z_top_m": "90e3",
           "lines.source": "synthetic:co2_43um,co2_43um_hot",
           "nlte.enabled": "true", "nlte.t_vib": "demo:co2_pump",
           "geometry.tangent_heights_km": "40.0,70.0"}


@pytest.mark.parametrize("overrides,rtol,atol_rel", [
    ({}, 5e-5, 1e-5),
    ({"compute.dtype": "float64"}, 1e-9, 0.0),
    ({"geometry.mode": "nadir", "geometry.sec_theta": "1.0,1.4"}, 5e-5,
     1e-5),
    ({**CONFIG3, "compute.dtype": "float64"}, 0.0, 1e-10),
    ({"compute.dtype": "float64", "compute.variant": "weideman"}, 0.0,
     1e-10),
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
    ("lines.chi=co2_mars", "lines.chi"),
    ("compute.mesh_nu=2", "compute.mesh_nu"),
])
def test_unported_key_raises_naming_it(tiny_toml, tmp_path, override, key):
    # Every key is ported; what a run cannot do raises a ValueError naming
    # its key: a mesh of more ranks than the run has (one, here), and chi
    # beyond the cutoff its single-segment form is valid to.
    extra = ["-o", "compute.cutoff_cm1=40"] if key == "lines.chi" else []
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        cli.main(["forward", tiny_toml, "--device", "cpu", "-o", override,
                  "-o", f"run.output_dir={tmp_path}", *extra])
    assert not os.path.exists(os.path.join(tmp_path, "forward.npz"))


@pytest.mark.parametrize("overrides", [
    {"compute.dtype": "float64"},
    {"compute.dtype": "float64", "compute.variant": "weideman",
     "cia.enabled": "true", "geometry.mode": "nadir",
     "geometry.sec_theta": "1.0,1.4"},
    {},
])
def test_save_optics_matches_jax_cli(tiny_toml, tmp_path, capsys, overrides):
    """run.save_optics: the same files as the JAX CLI, optics.npz with the
    reference's keys, each ray's LOS optical depth on the fine grid within
    1e-10 of max in float64 (the float32 run within K1's float32 budget)
    and its transmittance exp(-tau); the stderr line; forward.npz equal to
    a run without the flag."""
    ov = {**overrides, "run.save_optics": "true"}
    _jax_forward(tiny_toml, ov, tmp_path / "jax")
    capsys.readouterr()
    _torch_forward(tiny_toml, ov, tmp_path / "torch")
    err = capsys.readouterr().err
    assert (f"optics: LOS tau + transmittance -> "
            f"{tmp_path / 'torch' / 'optics.npz'}") in err
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(
        os.listdir(tmp_path / "jax"))
    ref = np.load(tmp_path / "jax" / "optics.npz")
    got = np.load(tmp_path / "torch" / "optics.npz")
    assert sorted(got.files) == sorted(ref.files) == [
        "kind", "nu", "transmittance", "units", "values"]
    assert str(got["kind"]) == "optical_depth" and str(got["units"]) == "1"
    np.testing.assert_array_equal(got["nu"], ref["nu"])
    tol = 1e-10 if overrides else 1e-5
    for key in ("values", "transmittance"):
        assert got[key].shape == ref[key].shape == (2, 256)
        np.testing.assert_allclose(got[key], ref[key], rtol=0,
                                   atol=tol * np.abs(ref[key]).max())
    np.testing.assert_array_equal(got["transmittance"],
                                  np.exp(-got["values"]))
    plain = _torch_forward(tiny_toml, overrides, tmp_path / "no_optics")
    with np.load(tmp_path / "torch" / "forward.npz") as f:
        np.testing.assert_array_equal(f["values"], plain["values"])


@pytest.mark.parametrize("override", ["compute.use_lut=true",
                                      "compute.mesh_nu=2"])
def test_save_optics_off_the_direct_forward(tiny_toml, tmp_path, override):
    """run.save_optics with the table tier or a mesh: the reference refuses
    it (its optics reuse the single-device line-by-line depths), and so
    does the port, before writing anything: the same (empty) file set."""
    from spectrobot_tpu.cli import main as jax_main
    argv = ["forward", tiny_toml, "-o", "run.save_optics=true", "-o",
            override]
    with pytest.raises(ValueError, match="run.save_optics"):
        jax_main(argv + ["-o", f"run.output_dir={tmp_path / 'jax'}"])
    with pytest.raises(ValueError, match="run.save_optics"):
        cli.main(argv + ["--device", "cpu", "-o",
                         f"run.output_dir={tmp_path / 'torch'}"])
    assert not os.path.exists(tmp_path / "jax")
    assert not os.path.exists(tmp_path / "torch")


def test_config3_scene_stages_differing_rows(tiny_toml):
    """The non-LTE levels are matched on the host line list before it is
    staged: every config-3 line carries its level indices, and the rows the
    forward gives the line sum (w_abs u and w_em u) differ on the pumped
    rays aloft.  On a CUDA device that is not there the same run raises."""
    from spectrobot_tpu_torch.ops.opacity import Engine

    cfg = load_config(tiny_toml, {**CONFIG3, "compute.dtype": "float64"})
    scene = cli.build_scene(cfg, torch.device("cpu"))
    assert bool((scene.lines.level_upper >= 0).all())
    assert bool((scene.lines.level_lower >= 0).all())
    seen = []

    def record(nu, windows, nu_c, sx, y, amps, **kw):
        seen.append(amps)
        return torch.zeros(amps.shape[:-1] + nu.shape, dtype=nu.dtype)

    cli.run_forward(cfg, scene, Engine("record", record, None))
    (amps,) = seen
    rows = amps.reshape(2, -1, 2, amps.shape[-1])      # [ray, layer, 2, L]
    top = rows[1, -4:]                                 # 70 km ray, aloft
    assert float((top[:, 0] - top[:, 1]).abs().max()) > \
        0.1 * float(top.abs().max())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["forward", tiny_toml, *[a for k, v in CONFIG3.items()
                                              for a in ("-o", f"{k}={v}")]])


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
    rule on CUDA takes only the float32 kernel configuration for
    humlicek4, while on the CPU the same wrappers run their plain versions
    in any configuration.  compute.variant = "weideman" takes the WEIDEMAN
    engine on both devices, in either dtype, and the kernels refuse it."""
    import torch

    from spectrobot_tpu_torch.data.synth import co2_15um_band
    from spectrobot_tpu_torch.ops.cuda_basis import WEIDEMAN
    from spectrobot_tpu_torch.ops.opacity import cross_sections
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = load_config(tiny_toml)
    assert cli.select_engine(cfg, cuda) is cli.KERNELS
    for dev in (cuda, cpu):
        for dtype in ("float32", "float64"):
            for pallas in ("true", "false"):
                assert cli.select_engine(load_config(tiny_toml, {
                    "compute.variant": "weideman", "compute.dtype": dtype,
                    "compute.use_pallas": pallas}), dev) is WEIDEMAN
        with pytest.raises(ValueError, match="unknown voigt variant"):
            cli.select_engine(load_config(tiny_toml, {
                "compute.variant": "voigt"}), dev)
    dl = device_lines_from_linelist(co2_15um_band(j_max=4), [(2, 1)],
                                    dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="evaluates humlicek4 only"):
        cross_sections(torch.linspace(660.0, 670.0, 64), dl, 200.0, 300.0,
                       variant="weideman", engine=cli.KERNELS)
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
    # the Weideman evaluator (compute.variant), T and ln VMR(CO2)
    "weideman_vmr": TINY_TOML.replace("[compute]", """\
[retrieval]
retrieve_vmr = ["CO2"]
max_iter = 6
[compute]
variant = "weideman"
"""),
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
    # config 3 in small: non-LTE 4.3 um limb, the demo nu3 pumping
    "config3_nlte": TINY_TOML.replace("nu_min = 660.0", "nu_min = 2320.0")
    .replace("nu_max = 674.0", "nu_max = 2360.0")
    .replace("z_top_m = 60e3", "z_top_m = 90e3")
    .replace("[geometry]", """\
[lines]
source = "synthetic:co2_43um,co2_43um_hot"
[nlte]
enabled = true
t_vib = "demo:co2_pump"
[geometry]""").replace("[8.0, 25.0]", "[40.0, 70.0]")
    .replace("[compute]", """\
[retrieval]
max_iter = 6
[compute]"""),
    # a CO2-CO2 continuum from a HITRAN-format .cia file, in band
    "cia_table": TINY_TOML.replace("[geometry]", """\
[cia]
enabled = true
tables = ["CO2-CO2:{cia}"]
[geometry]""").replace("[compute]", """\
[retrieval]
max_iter = 6
[compute]"""),
    # the field of view: 6 fine rays smeared into the 2 observed
    "fov": TINY_TOML.replace("n_channels = 32", """\
n_channels = 32
fov_fwhm_km = 6.0
fov_n_fine = 6""").replace("[compute]", """\
[retrieval]
max_iter = 6
[compute]"""),
    # the (P, T) table tier: the forward and every LM iteration through a
    # 7 x 9 table, built once
    "lut": TINY_TOML.replace("[compute]", """\
[retrieval]
max_iter = 6
[compute]
use_lut = true
lut_n_T = 7
lut_n_p = 9"""),
    # the table tier in nadir, ln VMR(CO2) with T
    "lut_nadir_vmr": TINY_TOML.replace("[geometry]", """\
[geometry]
mode = "nadir"
sec_theta = [1.0, 1.4]""").replace("[compute]", """\
[retrieval]
retrieve_vmr = ["CO2"]
max_iter = 6
[compute]
use_lut = true
lut_n_T = 7
lut_n_p = 9"""),
    # config 3 in small through the non-LTE tables (4 x 5), the vibrational
    # temperatures from a profile file (tests/test_cli_config.py:274)
    "lut_nlte_tvib_file": TINY_TOML
    .replace("nu_min = 660.0", "nu_min = 2320.0")
    .replace("nu_max = 674.0", "nu_max = 2360.0")
    .replace("z_top_m = 60e3", "z_top_m = 90e3")
    .replace("[geometry]", """\
[lines]
source = "synthetic:co2_43um,co2_43um_hot"
[nlte]
enabled = true
t_vib = "{tvib}"
[geometry]""").replace("[8.0, 25.0]", "[40.0, 65.0]")
    .replace("[compute]", """\
[retrieval]
max_iter = 6
[compute]
use_lut = true
lut_n_T = 4
lut_n_p = 5"""),
    # a 2-D climatology sliced at 45 deg N
    "zonal_45N": TINY_TOML.replace("[scene]", """\
[scene]
atmosphere = "mars_zonal"
latitude_deg = 45.0""").replace("[compute]", """\
[retrieval]
max_iter = 6
[compute]"""),
}


def _tvib_file(path) -> str:
    """Vibrational temperatures of the two nu3 levels, 1.3 x the kinetic
    profile for the upper one (tests/test_cli_config.py's file)."""
    from spectrobot_tpu.data.nlte import save_t_vib_npz
    z = np.linspace(0.0, 90e3, 10)
    t_kin = np.linspace(210.0, 150.0, 10)
    save_t_vib_npz(str(path), z, ["2:1:0001", "2:1:0111"],
                   t_kin[None, :] * np.array([[1.0], [1.3]]))
    return str(path)


def _cia_file(path) -> str:
    """A HITRAN-format .cia file of a CO2-CO2 continuum over the tiny
    scene's band (three temperatures; test data)."""
    nu = np.linspace(640.0, 700.0, 61)
    out = []
    for T in (150.0, 200.0, 300.0):
        k = 1e-43 * (200.0 / T) * np.exp(-0.5 * ((nu - 668.0) / 20.0) ** 2)
        out.append(f"CO2-CO2 {nu[0]:.3f} {nu[-1]:.3f} {len(nu)} {T:.1f} "
                   f"{k.max():.3e}")
        out += [f"{x:.4f} {v:.6e}" for x, v in zip(nu, k)]
    path.write_text("\n".join(out) + "\n")
    return str(path)


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
    if "{cia}" in text:
        text = text.replace("{cia}", _cia_file(tmp_path / "co2.cia"))
    if "{tvib}" in text:
        text = text.replace("{tvib}", _tvib_file(tmp_path / "tvib.npz"))
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


def test_lut_cache_through_the_cli(tiny_toml, tmp_path, capsys):
    """compute.lut_path: the first forward builds and writes the table, the
    second loads it (the same radiances), and a changed lattice misses the
    cache; the stderr line names where the table came from."""
    path = str(tmp_path / "lut.npz")
    ov = {"compute.dtype": "float64", "compute.use_lut": "true",
          "compute.lut_n_T": "5", "compute.lut_n_p": "6",
          "compute.lut_path": path}
    runs = []
    for extra in ({}, {}, {"compute.lut_n_T": "6"}):
        capsys.readouterr()
        out = _torch_forward(tiny_toml, {**ov, **extra}, tmp_path / "o")
        runs.append((out["values"], capsys.readouterr().err))
    assert "(LUT runtime: LTE, built)" in runs[0][1]
    assert f"(LUT runtime: LTE, cached {path})" in runs[1][1]
    assert "(LUT runtime: LTE, built)" in runs[2][1]
    np.testing.assert_array_equal(runs[1][0], runs[0][0])
