"""The port's weak-scaling tool (spectrobot_tpu_torch.scaling, the port of
benchmarks/scaling.py) on the CPU: its scene, lines and nu-halo partition
against the same built by the JAX package (float64); its 1-rank mesh
forward against the reference's limb_radiance at the reference's cutoffs
in both tiers; the mesh forward of 2 gloo ranks against that of 1 rank on
the same grid; and the tool itself, 1 and 2 ranks under
torch.distributed.run, printing the reference's records in both tiers."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band, random_lines
from spectrobot_tpu.forward.geometry import limb_path_cg
from spectrobot_tpu.forward.limb import limb_radiance
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu.parallel import sharded as j_sharded
from spectrobot_tpu_torch import scaling
from spectrobot_tpu_torch.parallel.sharded import partition_lines_by_nu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
N_LINES, N_RAYS, N_POINTS = 40, 2, 256


def _jax_scene(n_lines, n_rays):
    """benchmarks/scaling.py's scene in float64: co2_15um_band(j_max=40)
    and random_lines(n_lines, 560, 780, seed=2); 21 levels to 90 km;
    n_rays rays at 6-80 km, n_sub 2."""
    f64 = jnp.float64
    ll = co2_15um_band(j_max=40).concat(
        random_lines(n_lines, 560.0, 780.0, seed=2))
    dl = j_stage(ll, [(2, 1)], dtype=f64)
    atm = jax.tree.map(lambda a: jnp.asarray(a, f64),
                       mars_standard_atmosphere(n_lev=21, z_top=90e3))
    cg = limb_path_cg(atm, ["CO2"], jnp.asarray(np.linspace(6e3, 80e3,
                                                            n_rays)),
                      J_MARS, n_sub=2)
    return dl, cg


def _ref_cutoff(n, halo):
    """The reference's cutoff: sharded_radiance_fn's 25 cm-1 in the psum
    tier, min(10, 0.9 x 140 / n) in the nu-halo tier (scaling.py:137)."""
    return min(10.0, 0.9 * 140.0 / n) if halo else 25.0


@pytest.mark.parametrize("n", [2, 4])
def test_scene_and_partition_match_reference(n):
    """scaling.scene's lines and paths, and the nu-halo tier's owner-shard
    partition of its lines on n shards at its cutoff, equal the reference's
    (float64)."""
    dl, cg = scaling.scene(torch.device("cpu"), torch.float64, N_LINES,
                           N_RAYS)
    j_dl, j_cg = _jax_scene(N_LINES, N_RAYS)
    for f in ("u", "T_sp", "p_sp", "p_self_sp", "T_air", "seg_layer"):
        np.testing.assert_allclose(getattr(cg, f).numpy(),
                                   np.asarray(getattr(j_cg, f)), rtol=1e-12,
                                   err_msg=f)
    assert cg.u.shape == (N_RAYS, 20, 1)
    sizes = (1, 2, 4, 8, 16, 32)
    assert [scaling.halo_cutoff(k) for k in sizes] == [
        _ref_cutoff(k, True) for k in sizes]
    assert scaling.PSUM_CUTOFF == _ref_cutoff(n, False)
    nu_host = np.linspace(600.0, 740.0, N_POINTS * n)
    got = partition_lines_by_nu(dl, nu_host, n,
                                cutoff_cm1=scaling.halo_cutoff(n))
    ref = j_sharded.partition_lines_by_nu(j_dl, nu_host, n,
                                          cutoff_cm1=_ref_cutoff(n, True))
    for f in j_sharded._PAD_FILLS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-12,
                                   err_msg=f)


def test_one_rank_matches_reference(tmp_path):
    """The tool's (1, 1, 1) mesh forward on a 256-point grid against the
    reference's limb_radiance at the reference's cutoff of each tier,
    within 1e-10 of max (float64)."""
    one = cases.run(tmp_path, 1, cases.scaling_case, N_POINTS, N_LINES,
                    N_RAYS)[0]
    dl, cg = _jax_scene(N_LINES, N_RAYS)
    nu = np.linspace(600.0, 740.0, N_POINTS)
    for halo in (False, True):
        ref = np.asarray(limb_radiance(
            jnp.asarray(nu), dl, cg, nu_off=jnp.asarray(nu - float(dl.nu_ref)),
            cutoff_cm1=_ref_cutoff(1, halo), engine="jnp"))
        got = one[halo].numpy()
        assert got.shape == ref.shape == (N_RAYS, N_POINTS)
        assert np.isfinite(got).all() and ref.max() > 0
        assert np.max(np.abs(got - ref)) <= 1e-10 * np.abs(ref).max()


def test_two_ranks_equal_one(tmp_path):
    """The scaling tool's mesh forward at n = 2 against n = 1 on the same
    256-point grid, within 1e-10 of max (float64), psum and nu-halo."""
    one = cases.run(tmp_path / "one", 1, cases.scaling_case, 256, 40, 2)[0]
    two = cases.run(tmp_path / "two", 2, cases.scaling_case, 256, 40, 2)
    for halo in (False, True):
        ref = one[halo].numpy()
        got = torch.cat([r[halo] for r in two], dim=-1).numpy()
        assert got.shape == ref.shape == (2, 256)
        assert np.isfinite(got).all() and ref.max() > 0
        assert np.max(np.abs(got - ref)) <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("halo", [False, True])
def test_tool_prints_the_reference_records(tmp_path, halo):
    """``python -m spectrobot_tpu_torch.scaling --device cpu`` at tiny
    sizes: the 1-device overhead record, then one record for 1 and 2
    ranks with the reference's keys and the card; --json-out holds them
    under the CPU's label."""
    out = tmp_path / "scaling.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "spectrobot_tpu_torch.scaling", "--device",
         "cpu", "--points-per-device", "128", "--lines", "40", "--rays",
         "2", "--reps", "1", "--json-out", str(out)]
        + (["--halo"] if halo else []),
        cwd=REPO, capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    recs = [json.loads(s) for s in proc.stdout.splitlines()
            if s.startswith("{")]
    over, *sizes = recs
    assert set(over) == {"metric", "t_plain_s", "t_mesh_s", "overhead_frac",
                         "card"}
    assert over["metric"] == "sharded_overhead_1dev"
    assert [r["n_devices"] for r in sizes] == [1, 2]
    for r in sizes:
        assert set(r) == {"n_devices", "grid_points", "halo", "wall_s",
                          "grid_points_per_s", "efficiency_vs_1dev", "card"}
        assert r["halo"] is halo and r["card"] == "cpu"
        assert r["grid_points"] == 128 * r["n_devices"]
        assert r["wall_s"] > 0 and r["grid_points_per_s"] > 0
    assert sizes[0]["efficiency_vs_1dev"] == 1.0
    saved = json.loads(out.read_text())
    assert saved["label"] == "cpu, gloo ranks"
    assert saved["records"] == recs
