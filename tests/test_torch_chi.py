"""The sub-Lorentzian chi wing correction of the PyTorch port
(``spectrobot_tpu_torch.ops.chi``, ``line_kernel_inputs(chi=)``, the CLI's
``lines.chi``) against the JAX reference: tests/test_chi.py's engine parity
and reverse-mode cases ported, the profile and the per-line slopes, and the
CLI forward and retrieve with ``lines.chi = "co2_mars"`` on one device and
on a 2-rank gloo mesh."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.config import load_config
from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.ops import chi as jchi
from spectrobot_tpu.ops import opacity as jop
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu_torch import cli, interop
from spectrobot_tpu_torch.ops import chi as tchi
from spectrobot_tpu_torch.ops import opacity as top
from spectrobot_tpu_torch.parallel.mesh import _free_port

import torch_mesh_cases as cases
from test_torch_cli import TINY_TOML

# These tests run tiny tensors: torch's intra-op threads would only
# contend (and spin-wait) with the other test workers for the cores.
torch.set_num_threads(1)


def _lines(dtype):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    dl = j_stage(co2_15um_band(j_max=10), [(2, 1)], dtype=jdt)
    tl = interop.device_lines_from_numpy(
        {k: np.asarray(v) for k, v in dl._asdict().items()},
        device=torch.device("cpu"))
    return dl, tl


def test_profile_and_factor_match_jax():
    prof, jprof = tchi.CHI_PROFILES["co2_mars"], jchi.CHI_PROFILES["co2_mars"]
    assert tuple(prof) == tuple(jprof)
    assert (tchi.CHI_DELTA1, tchi.CHI_MAX_CUTOFF) == (jchi.CHI_DELTA1,
                                                      jchi.CHI_MAX_CUTOFF)
    T = np.array([140.0, 200.0, 270.0, 1000.0])
    b = prof.slope(torch.as_tensor(T)).numpy()
    np.testing.assert_allclose(b, np.asarray(jprof.slope(jnp.asarray(T))),
                               rtol=1e-15)
    # The P&H first-segment slope grows with T over the Mars range, >= 0.
    assert np.all(b >= 0) and np.all(np.diff(b[:3]) > 0)
    assert float(prof.slope(200.0)) == pytest.approx(b[1], rel=1e-15)
    dnu = np.linspace(0.0, 25.0, 11)
    np.testing.assert_array_equal(tchi.chi_factor_np(dnu, 0.05),
                                  jchi.chi_factor_np(dnu, 0.05))


def test_chi_slopes_for_lines():
    """Slopes where the line's molecule is the profile's, 0 elsewhere."""
    class Lines:
        mol_of_line = torch.tensor([2, 5, 2])
    prof = tchi.CHI_PROFILES["co2_mars"]
    T = torch.tensor([150.0, 200.0, 250.0], dtype=torch.float64)
    b = tchi.chi_slopes_for_lines(prof, Lines, T)
    np.testing.assert_array_equal(b.numpy(), [float(prof.slope(150.0)), 0.0,
                                              float(prof.slope(250.0))])
    assert tchi.chi_slopes_for_lines(None, Lines, T) is None


@pytest.mark.parametrize("mask", [(True,), (False,)])
def test_line_kernel_inputs_chi_matches_jax(mask):
    dl, tl = _lines(torch.float64)
    chi = (tchi.CHI_PROFILES["co2_mars"], mask)
    jkl = jop.line_kernel_inputs(dl, 210.0, 500.0, 480.0,
                                 chi=(jchi.CHI_PROFILES["co2_mars"], mask))
    kl = top.line_kernel_inputs(tl, 210.0, 500.0, 480.0, chi=chi)
    np.testing.assert_allclose(kl.chi_b.numpy(), np.asarray(jkl.chi_b),
                               rtol=1e-14, atol=0)
    assert np.all(kl.chi_b.numpy() > 0) == mask[0]
    # Per-line temperatures [..., L] (the limb prologue's states).
    T = torch.full((3, tl.n_lines), 210.0, dtype=torch.float64)
    klb = top.line_kernel_inputs(tl, T, 500.0, 480.0, chi=chi)
    np.testing.assert_array_equal(klb.chi_b[1].numpy(), kl.chi_b.numpy())


def test_chi_off_is_bit_identical():
    dl, tl = _lines(torch.float64)
    kl = top.line_kernel_inputs(tl, 210.0, 500.0, 480.0,
                                chi=(tchi.CHI_PROFILES["co2_mars"], (True,)))
    nu = torch.as_tensor(np.linspace(640.0, 700.0, 768) - float(tl.nu_ref))
    a = top.accumulate_plain(nu, kl._replace(chi_b=None))
    b = top.accumulate_plain(nu, kl._replace(chi_b=torch.zeros_like(kl.y)))
    assert torch.equal(a, b)


def _parity_case():
    """tests/test_chi.py's engine-parity case: float32 lines of the CO2
    band with chi, 512 points."""
    dl, tl = _lines(torch.float32)
    jkl = jop.line_kernel_inputs(dl, 210.0, 500.0, 480.0,
                                 chi=(jchi.CHI_PROFILES["co2_mars"], (True,)))
    kl = top.line_kernel_inputs(tl, 210.0, 500.0, 480.0,
                                chi=(tchi.CHI_PROFILES["co2_mars"], (True,)))
    nu = np.linspace(640.0, 700.0, 512) - float(dl.nu_ref)
    return (jnp.asarray(nu, jnp.float32), jkl,
            torch.as_tensor(nu, dtype=torch.float32), kl)


def test_chi_engine_parity_primal_and_tangent():
    """The port's single-state op with chi (plain versions of K3 and K4)
    against the reference's jnp and Pallas (interpret) ops: the primal and
    one tangent, with tests/test_chi.py's tolerances."""
    jnu, jkl, nu, kl = _parity_case()
    args_j = (jkl.nu_c, jkl.scale_x, jkl.y, jkl.amps, jkl.chi_b)
    args_t = (kl.nu_c, kl.scale_x, kl.y, kl.amps, kl.chi_b)
    op = top.make_accumulate_op(mode="fwd", has_chi=True, cutoff_cm1=25.0)
    got = op(nu, *args_t).numpy()
    tang_j = (jnp.zeros_like(jkl.nu_c), jnp.full_like(jkl.scale_x, 1e-3),
              jnp.full_like(jkl.y, 1e-3), jnp.full_like(jkl.amps, 1e-5),
              jnp.zeros_like(jkl.chi_b))
    tang_t = tuple(torch.as_tensor(np.array(v)) for v in tang_j)
    _, tt = torch.func.jvp(lambda *a: op(nu, *a), args_t, tang_t)
    for engine in ("jnp", "pallas"):
        jop_ = jop.make_accumulate_op(engine=engine, mode="fwd", has_chi=True,
                                      cutoff_cm1=25.0,
                                      interpret=engine == "pallas")
        ref = np.asarray(jop_(jnu, *args_j))
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=np.abs(ref).max() * 1e-7)
        _, tj = jax.jvp(lambda *a: jop_(jnu, *a), args_j, tang_j)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-5,
                                   atol=float(jnp.abs(tj).max()) * 1e-6)


def test_chi_rev_mode_engine_parity():
    """Reverse mode carries chi with the same frozen-chi convention: the
    port's gradients (plain K3 + K5 at B = 1) equal the reference's, and
    the dot-product identity with the forward-mode tangent holds."""
    jnu, jkl, nu, kl = _parity_case()
    w = np.random.default_rng(3).normal(size=(2, nu.shape[0]))
    rev = top.make_accumulate_op(mode="rev", has_chi=True, cutoff_cm1=25.0)
    fwd = top.make_accumulate_op(mode="fwd", has_chi=True, cutoff_cm1=25.0)
    tw = torch.as_tensor(w, dtype=torch.float32)
    args = [a.clone().requires_grad_() for a in kl[:4]]
    g = torch.autograd.grad((rev(nu, *args, kl.chi_b) * tw).sum(), args)
    jrev = jop.make_accumulate_op(engine="pallas", mode="rev", has_chi=True,
                                  cutoff_cm1=25.0, interpret=True)
    gj = jax.grad(lambda *a: jnp.sum(jrev(jnu, *a, jkl.chi_b) * w),
                  argnums=(0, 1, 2, 3))(*jkl[:4])
    for a, b in zip(g, gj):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=np.abs(b).max() * 1e-5)
    v = [torch.as_tensor(np.random.default_rng(k).normal(size=a.shape)
                         * 1e-3, dtype=torch.float32)
         for k, a in enumerate(kl[:4])]
    _, t = torch.func.jvp(lambda *a: fwd(nu, *a, kl.chi_b), tuple(kl[:4]),
                          tuple(v))
    lhs = float((t.double() * tw.double()).sum())
    rhs = sum(float((a.double() * b.double()).sum()) for a, b in zip(g, v))
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), abs(rhs))


def test_chi_guard_refuses_a_long_cutoff():
    from spectrobot_tpu_torch.forward.geometry import nadir_path_cg
    from spectrobot_tpu_torch.forward.limb import layer_tau_kernel
    from spectrobot_tpu_torch.data.atmosphere import mars_standard_atmosphere
    _, tl = _lines(torch.float64)
    atm = mars_standard_atmosphere(n_lev=4, z_top=40e3,
                                   device=torch.device("cpu"))
    cg = nadir_path_cg(atm, ["CO2"], torch.tensor([1.0],
                                                  dtype=torch.float64), 2)
    nu = torch.linspace(-5.0, 5.0, 32, dtype=torch.float64)
    with pytest.raises(ValueError, match="Perrin-Hartmann"):
        layer_tau_kernel(nu, tl, cg, None, cutoff_cm1=40.0,
                         chi=(tchi.CHI_PROFILES["co2_mars"], (True,)))


@pytest.fixture(scope="module")
def tiny_toml(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.toml"
    path.write_text(TINY_TOML)
    return str(path)


@pytest.mark.parametrize("overrides,rtol,atol_rel", [
    ({}, 5e-5, 1e-5),
    ({"compute.dtype": "float64"}, 1e-9, 0.0),
    ({"geometry.mode": "nadir", "geometry.sec_theta": "1.0,1.4"}, 5e-5,
     1e-5),
])
def test_cli_forward_with_chi_matches_jax(tiny_toml, tmp_path, overrides,
                                          rtol, atol_rel):
    """The CLI forward with lines.chi = "co2_mars" against the reference's
    CLI on the same TOML (tests/test_torch_cli.py's budgets); chi changes
    the radiances."""
    from spectrobot_tpu.cli import cmd_forward
    ov = {**overrides, "lines.chi": "co2_mars"}
    cfg = load_config(tiny_toml, {**ov, "run.output_dir": str(tmp_path / "j")})
    ref = np.load(cmd_forward(cfg)["output"])["values"]
    argv = ["forward", tiny_toml, "--device", "cpu", "-o",
            f"run.output_dir={tmp_path / 't'}"]
    for k, v in ov.items():
        argv += ["-o", f"{k}={v}"]
    assert cli.main(argv) == 0
    got = np.load(tmp_path / "t" / "forward.npz")["values"]
    assert np.all(np.isfinite(got)) and np.all(got >= 0)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_rel * ref.max())
    assert cli.main(argv[:-2] + ["-o", f"run.output_dir={tmp_path / 'n'}",
                                 "-o", "lines.chi="]) == 0
    off = np.load(tmp_path / "n" / "forward.npz")["values"]
    assert np.max(np.abs(off - got)) > 1e-4 * np.abs(off).max()


CHI_CLI = ["-o", "compute.dtype=float64", "-o", "compute.cutoff_cm1=5",
           "-o", "retrieval.max_iter=3", "-o", "lines.chi=co2_mars"]


def test_cli_with_chi_on_a_mesh_matches_single_device(tiny_toml, tmp_path):
    """forward (nu-halo tier) and retrieve (psum tier) with lines.chi under
    2 gloo ranks against the single-device CLI, float64; the single-device
    retrieve converges."""
    single = tmp_path / "single"
    for cmd in ("forward", "retrieve"):
        assert cli.main([cmd, tiny_toml, "--device", "cpu", "-o",
                         f"run.output_dir={single}", *CHI_CLI]) == 0
    out = tmp_path / "mesh"
    runs = [(["forward", "-o", f"run.output_dir={out}", "-o",
              "compute.mesh_nu=2", "-o", "compute.mesh_halo=true",
              *CHI_CLI], _free_port()),
            (["retrieve", "-o", f"run.output_dir={out}", "-o",
              "compute.mesh_nu=2", *CHI_CLI], _free_port())]
    cases.run(tmp_path / "ranks", 2, cases.cli_case, tiny_toml, runs,
              join_group=False)
    ref = np.load(single / "forward.npz")["values"]
    got = np.load(out / "forward.npz")["values"]
    np.testing.assert_allclose(got, ref, rtol=1e-10,
                               atol=np.abs(ref).max() * 1e-12)
    ref = np.load(single / "retrieval.npz")
    got = np.load(out / "retrieval.npz")
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-8)
    np.testing.assert_allclose(got["chi2"], ref["chi2"], rtol=1e-8)
    with open(single / "run.jsonl") as f:
        chi2 = [json.loads(line)["chi2"] for line in f if '"chi2"' in line]
    assert chi2[-1] < chi2[0]
    assert os.path.exists(out / "run.jsonl")
