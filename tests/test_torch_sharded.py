"""The sharded forward of the port (spectrobot_tpu_torch/parallel/
sharded.py) in gloo ranks, in float64: the psum tier at meshes (1, 2, 1)
and (2, 1, 2) and the nu-halo tier at (1, 1, 2) and (1, 2, 2), limb and
nadir (grey surface), against JAX's sharded_radiance_fn on the emulated
mesh and against the port's single-device forward; and a padded owner
partition whose pads end a line block."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band, random_lines
from spectrobot_tpu.forward import geometry as jgeo
from spectrobot_tpu.ops.planck import planck_nu as j_planck
from spectrobot_tpu.ops.strengths import device_lines_from_linelist
from spectrobot_tpu.parallel import sharded as jsh
from spectrobot_tpu.parallel.mesh import make_mesh
from spectrobot_tpu_torch import interop
from spectrobot_tpu_torch.forward import limb as tlimb
from spectrobot_tpu_torch.ops import cuda_opacity as co
from spectrobot_tpu_torch.parallel import sharded as sh
from spectrobot_tpu_torch.parallel.mesh import Mesh

import torch_mesh_cases as cases

torch.set_num_threads(1)

CPU = torch.device("cpu")
CUT = 5.0            # the halo tier needs cutoff <= 25 cm-1 / 2 shards
T_SURF, EMIS = 230.0, 0.9
SHAPES = {2: [("psum", (1, 2, 1), False), ("halo", (1, 1, 2), True)],
          4: [("psum", (2, 1, 2), False), ("halo", (1, 2, 2), True)]}
# The padded owner partition's mesh and line buffer, by world size.
PADDED = {2: ((1, 1, 2), (2, 512)), 4: ((1, 2, 2), (2, 1024))}


def _np(nt) -> dict:
    return {k: (v if v is None or isinstance(v, (bool, int))
                else np.array(v)) for k, v in nt._asdict().items()}


def _scene(mode, lines=None, n_points=256, n_lev=11, rays=None):
    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=80e3)
    dl = device_lines_from_linelist(
        co2_15um_band(j_max=12) if lines is None else lines, [(2, 1)],
        dtype=jnp.float64)
    nu = np.linspace(655.0, 680.0, n_points)
    if mode == "limb":
        cg = jgeo.limb_path_cg(atm, ["CO2"], jnp.asarray(
            rays or [10e3, 20e3, 30e3, 40e3]), J_MARS, 2)
    else:
        cg = jgeo.nadir_path_cg(atm, ["CO2"], jnp.asarray(
            [1.0, 1.2, 1.5, 2.0]), 2)
    return {"nu": nu, "lines": _np(dl), "cg": _np(cg), "cutoff": CUT,
            "T_surface": None if mode == "limb" else T_SURF,
            "emissivity": 1.0 if mode == "limb" else EMIS}, (dl, cg)


def _padded_scene():
    """400 random lines partitioned into 2 owner shards of 512 slots: a
    full line block, a block that pads end, and pad blocks."""
    sc, jx = _scene("limb", random_lines(400, 656.0, 679.0, seed=9),
                    n_points=512, n_lev=7, rays=[10e3, 30e3])
    return {**sc, "round_to": 512}, jx


def _single_device(sc):
    """The port's single-device forward of a scene, float64."""
    nu = torch.as_tensor(sc["nu"])
    lines = interop.device_lines_from_numpy(sc["lines"], device=CPU)
    cg = interop.path_cg_from_numpy(sc["cg"], device=CPU)
    if sc["T_surface"] is None:
        return tlimb.limb_radiance(nu, lines, cg, cutoff_cm1=CUT).numpy()
    return tlimb.nadir_radiance(nu, lines, cg, T_SURF, emissivity=EMIS,
                                cutoff_cm1=CUT).numpy()


def _jax_sharded(shape, nu_halo, sc, jx):
    dl, cg = jx
    mesh = make_mesh(shape, jax.devices()[:int(np.prod(shape))])
    nu = jnp.asarray(sc["nu"])
    dlp = (jsh.partition_lines_by_nu(dl, sc["nu"], shape[2], cutoff_cm1=CUT,
                                     line_shards=shape[1])
           if nu_halo else jsh.pad_lines_for_mesh(dl, shape[1]))
    limb = sc["T_surface"] is None
    I_bg = None if limb else EMIS * j_planck(nu, T_SURF)
    f = jsh.sharded_radiance_fn(mesh, has_nlte=False,
                                has_background=not limb, cutoff_cm1=CUT,
                                nu_halo=nu_halo, is_limb=limb,
                                emissivity=EMIS if not limb else 1.0)
    nu_s, lines_s, cg_s, _, bg_s = jsh.stage_sharded(mesh, nu, dlp, cg,
                                                     I_bg=I_bg)
    return np.asarray(f(nu_s, lines_s, cg_s, None, bg_s))


def _assemble(blocks, shape, R, P):
    """The global [R, P] radiances from every rank's block; the ranks along
    ``line`` must hold the same block."""
    out = np.full((R, P), np.nan)
    for I_loc, coord, _ in blocks:
        I_loc = I_loc.numpy()
        r, p = I_loc.shape
        sl = (slice(coord["ray"] * r, (coord["ray"] + 1) * r),
              slice(coord["nu"] * p, (coord["nu"] + 1) * p))
        if coord["line"] > 0:
            np.testing.assert_array_equal(I_loc, out[sl])
        out[sl] = I_loc
    assert np.all(np.isfinite(out))
    return out


@pytest.fixture(scope="module", params=sorted(SHAPES))
def mesh_runs(request, tmp_path_factory):
    world = request.param
    scenes = {m: _scene(m) for m in ("limb", "nadir")}
    todo = [(f"{name}-{mode}", shape, halo, scenes[mode][0])
            for name, shape, halo in SHAPES[world] for mode in scenes]
    todo.append(("padded", PADDED[world][0], True, _padded_scene()[0]))
    got = cases.run(tmp_path_factory.mktemp(f"sharded{world}"), world,
                    cases.sharded_case, todo)
    return world, scenes, {name: [g[name] for g in got]
                           for name, *_ in todo}


@pytest.mark.parametrize("mode", ["limb", "nadir"])
@pytest.mark.parametrize("tier", ["psum", "halo"])
def test_sharded_matches(mesh_runs, tier, mode):
    world, scenes, got = mesh_runs
    (_, shape, halo), = [s for s in SHAPES[world] if s[0] == tier]
    sc, jx = scenes[mode]
    P, R = len(sc["nu"]), sc["cg"]["u"].shape[0]
    I = _assemble(got[f"{tier}-{mode}"], shape, R, P)
    for ref in (_single_device(sc), _jax_sharded(shape, halo, sc, jx)):
        np.testing.assert_allclose(I, ref, rtol=1e-10,
                                   atol=np.abs(ref).max() * 1e-12)


def test_padded_partition_multi_block(mesh_runs):
    """Owner slices of several 128-line blocks with a padded tail: the far
    pad center keeps the centers sorted, so the window tables build and
    the halo tier stays exact."""
    world, _, got = mesh_runs
    shape, buffer = PADDED[world]
    sc, _ = _padded_scene()
    assert got["padded"][0][2] == buffer
    I = _assemble(got["padded"], shape, 2, len(sc["nu"]))
    ref = _single_device(sc)
    np.testing.assert_allclose(I, ref, rtol=1e-10,
                               atol=np.abs(ref).max() * 1e-12)


class _Rank:
    """A mesh rank's coordinates without a process group (host-side
    window tables only)."""
    block = Mesh.block
    device = CPU

    def __init__(self, shape, coord):
        self.shape = dict(zip(("ray", "line", "nu"), shape))
        self.coord = dict(zip(("ray", "line", "nu"), coord))


@pytest.mark.parametrize("nu_halo", [False, True])
def test_rank_windows_cover_every_pair(nu_halo):
    """Each rank's window table, for its own lines and each neighbour's,
    visits every (tile, line block) pair with a line within the cutoff
    (plus the shift margin) of the tile: the kernels see every pair that
    contributes."""
    sc, (dl, _) = _padded_scene()
    nu_off = sc["nu"] - float(dl.nu_ref)
    lines = interop.device_lines_from_numpy(sc["lines"], device=CPU)
    dlp = (sh.partition_lines_by_nu(lines, sc["nu"], 2, cutoff_cm1=CUT,
                                    line_shards=2)
           if nu_halo else sh.pad_lines_for_mesh(lines, 2))
    nu0 = dlp.nu0.numpy()
    for k in range(2):
        for li in range(2):
            rank = _Rank((1, 2, 2), (0, li, k))
            wins = sh._rank_windows(rank, nu_off, nu0, nu_halo, CUT)
            grid = nu_off[rank.block(len(nu_off), "nu")]
            for s_i, win in wins.items():
                src = nu0[(k, k - 1, k + 1)[s_i] % 2] if nu_halo else nu0
                c = src[rank.block(len(src), "line")]
                c = np.concatenate([c, np.full(-len(c) % co.BLOCK_L, 1e9)])
                g = np.concatenate([grid, np.full(-len(grid) % co.TILE_P,
                                                  1e9)])
                near = (np.abs(g.reshape(-1, co.TILE_P, 1, 1)
                               - c.reshape(1, 1, -1, co.BLOCK_L))
                        <= CUT + co.SHIFT_MARGIN_CM1).any(axis=(1, 3))
                st, ct = win.starts.numpy(), win.counts.numpy()
                blk = np.arange(near.shape[1])
                seen = ((blk[None, :] >= st[:, None])
                        & (blk[None, :] < (st + ct)[:, None]))
                assert np.all(seen[near]), (k, li, s_i)
