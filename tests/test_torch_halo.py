"""The nu-mesh halo accumulation of the port (spectrobot_tpu_torch/parallel/
halo.py) and K3's wrapper (ops/cuda_single.py, its plain version on the
CPU) against the JAX package: the host-side partition, edges and origins
exactly; the halo sums of 2 and 4 gloo ranks against JAX's
halo_accumulate_fn / halo_accumulate_pallas_fn (interpret mode) on the
emulated mesh and against the single-device sum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.synth import random_lines
from spectrobot_tpu.ops.opacity import KernelLines as JKernelLines
from spectrobot_tpu.ops.opacity import accumulate_jnp, line_kernel_inputs
from spectrobot_tpu.ops.pallas_opacity import accumulate_pallas
from spectrobot_tpu.ops.strengths import device_lines_from_linelist
from spectrobot_tpu.parallel import halo as jhalo
from spectrobot_tpu.parallel.mesh import make_mesh
from spectrobot_tpu_torch.kernels import launch
from spectrobot_tpu_torch.ops import cuda_opacity as co
from spectrobot_tpu_torch.ops import cuda_single as cs
from spectrobot_tpu_torch.ops.opacity import KernelLines
from spectrobot_tpu_torch.parallel import halo

import torch_mesh_cases as cases

torch.set_num_threads(1)

CUTOFF = 10.0      # below the 4-shard width (100 / 4 = 25 cm-1)


def _scene(n_lines=600, P=1024, lo=600.0, hi=700.0):
    # Lines extend beyond the grid, so wings reach in from outside it.
    ll = random_lines(n_lines, lo - 20.0, hi + 20.0, seed=3)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float64,
                                    nu_ref=0.0)
    kl = line_kernel_inputs(dl, 210.0, 120.0, 40.0,
                            amp_weights=jnp.ones((2, dl.n_lines)))
    return np.asarray(dl.nu0), kl, np.linspace(lo, hi, P)


def _np(kl):
    return tuple(np.array(a) for a in kl[:4])


def _kl32(kl):
    return JKernelLines(*[None if a is None else a.astype(jnp.float32)
                          for a in kl])


def _torch_kl(kl, dtype=None):
    return KernelLines(*(torch.as_tensor(a, dtype=dtype) for a in _np(kl)))


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_edges_origins_rebase_match(n_shards):
    _, _, nu = _scene()
    edges = halo.nu_shard_edges(nu, n_shards, CUTOFF)
    np.testing.assert_array_equal(edges, jhalo.nu_shard_edges(
        nu, n_shards, CUTOFF))
    origins = halo.nu_shard_origins(edges)
    np.testing.assert_array_equal(origins, jhalo.nu_shard_origins(edges))
    for dt, jdt in ((torch.float32, np.float32), (torch.float64, np.float64)):
        np.testing.assert_array_equal(
            halo.rebase_grid_per_shard(nu, origins, dtype=dt).numpy(),
            np.asarray(jhalo.rebase_grid_per_shard(nu, origins, dtype=jdt)))


@pytest.mark.parametrize("origins,f32", [(False, False), (True, False),
                                         (True, True)])
def test_partition_matches(origins, f32):
    nu0, kl, nu = _scene(n_lines=321)
    edges = halo.nu_shard_edges(nu, 4, CUTOFF)
    o = halo.nu_shard_origins(edges) if origins else None
    ref = jhalo.partition_kernel_lines(
        kl, nu0, edges, origins=o, out_dtype=np.float32 if f32 else None)
    got = halo.partition_kernel_lines(
        _torch_kl(kl), nu0, edges, origins=o,
        out_dtype=torch.float32 if f32 else None)
    for name in ("nu_c", "scale_x", "y", "amps"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    # Every line lands on exactly one shard.
    assert int((got.amps[:, 0] != 0).sum()) == 321


def test_cutoff_wider_than_shard_rejected():
    _, _, nu = _scene(P=512)
    with pytest.raises(ValueError, match="compute.cutoff_cm1"):
        halo.nu_shard_edges(nu, 8, 50.0)


@pytest.fixture(scope="module", params=[2, 4])
def halo_ranks(request, tmp_path_factory):
    """The port's halo sums of ``n`` gloo ranks, assembled over the grid."""
    n = request.param
    nu0, kl, nu = _scene()
    edges = halo.nu_shard_edges(nu, n, CUTOFF)
    origins = halo.nu_shard_origins(edges)
    got = cases.run(tmp_path_factory.mktemp(f"halo{n}"), n, cases.halo_case,
                    nu, nu0, _np(kl), CUTOFF, edges, origins,
                    _np(_kl32(kl)))
    full = {k: torch.cat([g[k] for g in got], dim=-1).numpy()
            for k in got[0]}
    return n, (nu0, kl, nu, edges), full


def test_halo_plain_matches(halo_ranks):
    n, (nu0, kl, nu, edges), got = halo_ranks
    ref = np.asarray(accumulate_jnp(jnp.asarray(nu), kl, chunk=128,
                                    cutoff_cm1=CUTOFF))
    tol = dict(rtol=1e-11, atol=np.abs(ref).max() * 1e-13)
    np.testing.assert_allclose(got["plain"], ref, **tol)
    mesh = make_mesh((1, 1, n), jax.devices()[:n])
    jref = jhalo.halo_accumulate_fn(mesh, chunk=128, cutoff_cm1=CUTOFF)(
        jnp.asarray(nu), jhalo.partition_kernel_lines(kl, nu0, edges))
    np.testing.assert_allclose(got["plain"], np.asarray(jref), **tol)


def test_halo_per_shard_origins_exact_f64(halo_ranks):
    _, (_, kl, nu, _), got = halo_ranks
    ref = np.asarray(accumulate_jnp(jnp.asarray(nu), kl, chunk=128,
                                    cutoff_cm1=CUTOFF))
    np.testing.assert_allclose(got["origins"], ref, rtol=1e-10,
                               atol=np.abs(ref).max() * 1e-12)


def test_halo_kernel_path_matches(halo_ranks):
    """halo_accumulate_pallas_fn: K3's wrapper (its plain version on the
    CPU) in float32, against JAX's Pallas halo path in interpret mode and
    the single-device float32 sum (the reference's Pallas halo budget)."""
    n, (nu0, kl, nu, edges), got = halo_ranks
    kl32, nu32 = _kl32(kl), jnp.asarray(nu, jnp.float32)
    ref = np.asarray(accumulate_jnp(nu32, kl32, chunk=128,
                                    cutoff_cm1=CUTOFF))
    tol = dict(rtol=5e-5, atol=np.abs(ref).max() * 1e-6)
    np.testing.assert_allclose(got["kernel"], ref, **tol)
    mesh = make_mesh((1, 1, n), jax.devices()[:n])
    skl = jhalo.partition_kernel_lines(kl32, nu0, edges)
    f = jhalo.halo_accumulate_pallas_fn(
        mesh, np.asarray(nu32), np.asarray(skl.nu_c), tile_p=128,
        block_l=128, cutoff_cm1=CUTOFF, interpret=True)
    np.testing.assert_allclose(got["kernel"], np.asarray(f(nu32, skl)),
                               **tol)


# ---------------------------------------------------------------------------
# K3's wrapper on one state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_out,cutoff", [(1, 25.0), (2, None), (4, 25.0)])
def test_accumulate_single_matches_jax_kernel(n_out, cutoff):
    """accumulate_single on CPU tensors (its plain version) against the JAX
    K3 (accumulate_pallas, interpret mode): any number of amplitude rows,
    with and without a cutoff (the dense case)."""
    ll = random_lines(300, 615.0, 685.0, seed=5)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float32,
                                    nu_ref=0.0)
    rng = np.random.default_rng(n_out)
    w = jnp.asarray(rng.uniform(0.5, 1.5, (n_out, dl.n_lines)), jnp.float32)
    kl = line_kernel_inputs(dl, 200.0, 150.0, 20.0, amp_weights=w)
    nu = np.linspace(620.0, 680.0, 1000).astype(np.float32)
    ref = np.asarray(accumulate_pallas(jnp.asarray(nu), kl, tile_p=128,
                                       block_l=128, cutoff_cm1=cutoff,
                                       interpret=True))
    t = _torch_kl(kl, torch.float32)
    before = launch.LAUNCHES["opacity_single_kernel"]
    win = co.line_windows(nu, t.nu_c.numpy(), cutoff_cm1=cutoff)
    got = cs.accumulate_single(torch.as_tensor(nu), win, *t[:4],
                               cutoff_cm1=cutoff)
    # A CPU tensor: the plain version.
    assert launch.LAUNCHES["opacity_single_kernel"] == before
    assert got.shape == (n_out, len(nu))
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-5,
                               atol=np.abs(ref).max() * 1e-6)


@pytest.mark.parametrize("n_points,max_blocks", [(8192, 7), (16384, 160),
                                                 (256, 3), (128, 1)])
def test_segments_cover_every_window(n_points, max_blocks):
    """K3's segments of a window table: every block of the longest window
    falls in exactly one segment, none is empty, and the grid stays near
    TARGET_BLOCKS thread blocks (or one per block of the longest window)."""
    nu = np.linspace(0.0, 100.0, n_points)
    nu0 = np.linspace(0.0, 100.0, max_blocks * co.BLOCK_L)
    win = co.line_windows(nu, nu0, cutoff_cm1=None)
    assert win.max_blocks == max_blocks
    n_seg, seg_blocks = cs.segments(win)
    assert (n_seg - 1) * seg_blocks < max_blocks <= n_seg * seg_blocks
    n_tiles = win.nu_pad.shape[0] // co.TILE_P
    assert n_tiles * n_seg >= min(cs.TARGET_BLOCKS, n_tiles * max_blocks)


def test_accumulate_single_rejects_what_it_does_not_take():
    nu = torch.linspace(0.0, 10.0, 64)
    lines = torch.zeros(5), torch.ones(5), torch.ones(5)
    with pytest.raises(ValueError, match="one state"):
        cs.accumulate_single(nu, None, *(a[None] for a in lines),
                             torch.ones(1, 2, 5))
    with pytest.raises(ValueError, match="amps must have shape"):
        cs.accumulate_single(nu, None, *lines, torch.ones(2, 4))
