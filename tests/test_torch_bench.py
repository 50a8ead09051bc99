"""The port's measurement tool (spectrobot_tpu_torch.bench) against the
reference's bench.py: each scene at the reference's CPU sizes, built in
float64 by both packages (the reference on its jnp engine, as its own CPU
tests run), forward and Jacobian within 1e-10 of max; the dense single
state against the reference's accumulate_jnp; the roofline's pair count
against a brute-force count; and the tool's JSON lines."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band, random_lines
from spectrobot_tpu.forward.geometry import limb_path_cg
from spectrobot_tpu.forward.limb import limb_radiance
from spectrobot_tpu.ops import opacity as jop
from spectrobot_tpu.ops.ils import ils_matrix
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu.retrieval import state as jstate
from spectrobot_tpu_torch import bench, roofline

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
# The float64 parity budget: |diff| <= REL x max |reference|.
REL = 1e-10


def _jax_scene(ll, n_points, n_lev, n_rays):
    """The reference bench's limb scene (bench.py:122-152) in float64 on
    the jnp engine: (radiances, Jacobian) at the prior."""
    f64 = jnp.float64
    dl = j_stage(ll, [(2, 1)], dtype=f64)
    atm = jax.tree.map(lambda a: jnp.asarray(a, f64),
                       mars_standard_atmosphere(n_lev=n_lev, z_top=80e3))
    nu64 = np.linspace(600.0, 750.0, n_points)
    W = jnp.asarray(ils_matrix(nu64, np.linspace(605.0, 745.0, 256), 0.8))
    fwd = jstate.build_forward(
        atm, dl, jnp.asarray(nu64), ["CO2"], J_MARS,
        tangent_heights_m=jnp.asarray(np.linspace(5e3, 70e3, n_rays)),
        ils_W=W, nu_off=jnp.asarray(nu64 - float(dl.nu_ref)), engine="jnp")
    x0, unravel = jstate.flatten_state(jstate.make_state(atm, []))
    fwd_flat = lambda x: fwd(unravel(x))
    jac = jax.jit(lambda x: jstate.jacobian_fwd_chunked(fwd_flat, x,
                                                        chunk=32))
    return np.asarray(jax.jit(fwd_flat)(x0)), np.asarray(jac(x0))


def _close(got, ref):
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.max(np.abs(got - ref)) <= REL * np.abs(ref).max()


@pytest.mark.parametrize("name", ["limb_scan", "fused"])
def test_scene_matches_reference(name):
    """bench_limb_scan's and bench_fused_pallas's scenes at the
    reference's CPU sizes (bench.py:132, 187)."""
    if name == "limb_scan":
        scene = bench.limb_scan_scene
        ref = _jax_scene(co2_15um_band(j_max=80), 1024, 8, 4)
    else:
        scene = bench.fused_scene
        ref = _jax_scene(random_lines(256, 600.0, 750.0, seed=3), 512, 6, 2)
    fwd_flat, jac, x0 = scene(CPU, torch.float64)
    _close(fwd_flat(x0).numpy(), ref[0])
    _close(jac(x0).numpy(), ref[1])


def test_sharded_scene_matches_reference():
    """bench_sharded_pallas's scene (bench.py:240): the (1, 1, 1) mesh
    forward and the single-device forward against the reference's
    limb_radiance, float64."""
    from spectrobot_tpu_torch.parallel.mesh import initialize_multihost

    f64 = jnp.float64
    dl = j_stage(random_lines(256, 600.0, 750.0, seed=3), [(2, 1)],
                 dtype=f64)
    atm = jax.tree.map(lambda a: jnp.asarray(a, f64),
                       mars_standard_atmosphere(n_lev=6, z_top=80e3))
    nu64 = np.linspace(600.0, 750.0, 512)
    cg = limb_path_cg(atm, ["CO2"], jnp.asarray(np.linspace(5e3, 70e3, 2)),
                      J_MARS, 4)
    ref = np.asarray(limb_radiance(jnp.asarray(nu64), dl, cg,
                                   nu_off=jnp.asarray(nu64 - float(dl.nu_ref)),
                                   engine="jnp"))
    made = initialize_multihost("cpu")
    try:
        mesh_fn, cg_loc, single_fn, cg_t, block = bench.sharded_scene(
            CPU, torch.float64)
        I_mesh = mesh_fn(cg_loc).numpy()
        I_single = single_fn(cg_t).numpy()
    finally:
        if made:
            torch.distributed.destroy_process_group()
    assert block == slice(0, 512)
    _close(I_single, ref)
    _close(I_mesh, ref)


def test_dense_scene_matches_reference():
    """bench_kernel's dense single state (bench.py:291-296) at a small size
    against the reference's accumulate_jnp (no cutoff), float64."""
    run, amps, (nu, kl) = bench.dense_scene(CPU, torch.float64,
                                            n_points=300, n_lines=128)
    dl = j_stage(random_lines(128, 600.0, 740.0, seed=0), [(2, 1)],
                 dtype=jnp.float64, nu_ref=0.0)
    jkl = jop.line_kernel_inputs(dl, 220.0, 300.0, 100.0,
                                 amp_weights=jnp.ones((2, 128)))
    ref = np.asarray(jop.accumulate_jnp(
        jnp.asarray(np.linspace(640.0, 700.0, 300)), jkl, cutoff_cm1=None))
    for a, b in zip((kl.nu_c, kl.scale_x, kl.y, kl.amps),
                    (jkl.nu_c, jkl.scale_x, jkl.y, jkl.amps)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13)
    _close(run(amps).numpy(), ref)


def _brute_regions(nu, nu_c, sx, y, live, cutoff):
    counts = dict.fromkeys(roofline.REGIONS, 0)
    for b in np.nonzero(live)[0]:
        for i in range(nu_c.shape[1]):
            for p in nu:
                dnu = p - nu_c[b, i]
                if cutoff is not None and abs(dnu) > cutoff:
                    continue
                x, yy = abs(dnu * sx[b, i]), y[b, i]
                s = x + yy
                r = ("I" if s >= 15.0 else "II" if s >= 5.5 else
                     "IV" if yy < 0.195 * x - 0.176 else "III")
                counts[r] += 1
    return counts


@pytest.mark.parametrize("cutoff,step", [(3.0, 1 << 25), (None, 40),
                                         (3.0, 7)])
def test_region_counts_match_brute_force(monkeypatch, cutoff, step):
    """roofline.region_counts against a pair-by-pair count, also when a
    state's pairs are counted in several steps."""
    monkeypatch.setattr(roofline, "PAIRS_PER_STEP", step)
    rng = np.random.default_rng(5)
    B, L, P = 4, 9, 23
    nu = np.linspace(-10.0, 10.0, P)
    nu_c = np.sort(rng.uniform(-12.0, 12.0, (B, L)), axis=1)
    sx = 10.0 ** rng.uniform(-0.5, 1.0, (B, L))
    y = 10.0 ** rng.uniform(-2.0, 1.0, (B, L))
    live = np.array([True, False, True, True])
    t = torch.as_tensor
    got = roofline.region_counts(t(nu), t(nu_c), t(sx), t(y), t(live),
                                 cutoff)
    assert got == _brute_regions(nu, nu_c, sx, y, live, cutoff)


def test_bench_tool_prints_the_six_metrics():
    """``python -m spectrobot_tpu_torch.bench --device cpu``: one JSON line
    a measurement in the reference's order, the dense kernel's last; each
    names the card; vs_baseline only where its denominator is no other
    chip's time (the 1e9 target, the single-device forward)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "spectrobot_tpu_torch.bench", "--device",
         "cpu"], cwd=REPO, capture_output=True, text=True, env=env,
        timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(s) for s in proc.stdout.splitlines()
             if s.startswith("{")]
    names = [r["metric"] for r in lines]
    assert names == [
        "limb_scan_forward_jacobian_wall_s",
        "fused_pallas_forward_jacobian_wall_s",
        "sharded_pallas_forward_wall_s",
        "voigt_opacity_dense_evals_per_s_per_chip",
        "kernel_roofline_pct_of_fp32_peak",
        "fused_jacobian_audit_tflops_lower_bound",
        "voigt_opacity_dense_evals_per_s_per_chip"]
    for r in lines:
        assert r["card"] == "cpu" and np.isfinite(r["value"])
        assert r["value"] > 0
        assert ("vs_baseline" in r) == (r["metric"] in (
            "sharded_pallas_forward_wall_s",
            "voigt_opacity_dense_evals_per_s_per_chip"))
    assert lines[2]["max_rel_diff_vs_single"] <= 1e-12
    assert lines[0]["n_x"] == 8


def _fmaf_exact(x: float, a: float, b: float) -> float:
    """fmaf(x, a, b) from exact rationals: the float32 nearest to x a + b,
    ties to the even significand."""
    from fractions import Fraction

    exact = Fraction(x) * Fraction(a) + Fraction(b)
    c = np.float32(float(exact))
    near = [np.nextafter(c, np.float32(-np.inf)), c,
            np.nextafter(c, np.float32(np.inf))]
    dist = [abs(Fraction(float(v)) - exact) for v in near]
    best = min(dist)
    ties = [v for v, d in zip(near, dist) if d == best]
    return float(min(ties, key=lambda v: int(np.array(v).view(np.int32)) % 2))


@pytest.mark.parametrize("a,b", [(bench.FMA_A, bench.FMA_B),
                                 (1.0 + 2.0 ** -12, 2.0 ** -80),
                                 (1.0 + 2.0 ** -12, -2.0 ** -80),
                                 (0.7, -0.3)])
def test_fma_plain_link_rounds_once(a, b):
    """The FMA kernel's plain version (cuda_fma.fma_chain_plain) rounds
    each link x a + b once, as the card's fmaf does: against exact
    rationals on random float32 inputs and on a product that lies on a
    float32 midpoint with b beyond float64's reach (where a float64 sum
    rounded to float32 rounds twice and ties to even)."""
    from spectrobot_tpu_torch.ops import cuda_fma

    rng = np.random.default_rng(11)
    x = np.concatenate([rng.uniform(0.5, 2.0, 500), rng.uniform(-3, 3, 500),
                        [1.0 + 2.0 ** -12]]).astype(np.float32)
    a32, b32 = float(np.float32(a)), float(np.float32(b))
    got = cuda_fma.fma_chain_plain(torch.as_tensor(x), a, b, 1).numpy()
    want = np.array([_fmaf_exact(float(v), a32, b32) for v in x],
                    np.float32)
    assert np.array_equal(got, want)
    if a == 1.0 + 2.0 ** -12 and b > 0:
        # Above the midpoint: a float64 sum rounded to float32 lands on the
        # tie and rounds down to the even neighbour.
        twice = np.float32(float(x[-1]) * a32 + b32)
        assert twice != want[-1]
