"""Bodies of the port's multi-rank tests (tests/test_torch_{collectives,
halo,sharded,mesh_retrieval,dma_halo}.py).  :func:`run` starts ``world``
gloo ranks with ``torch.multiprocessing.spawn``; each runs one case
function of this module on numpy inputs made by the calling test and saves
what it returns.
This module imports torch and the port only (never jax), so the ranks start
light."""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CPU = torch.device("cpu")
# A deadlocked collective fails the test after this long instead of hanging.
TIMEOUT = timedelta(seconds=120)


def _entry(rank, world, tmp, case, args, join_group):
    torch.set_num_threads(1)
    if join_group:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                world_size=world, rank=rank, timeout=TIMEOUT)
    try:
        out = case(rank, world, *args)
    finally:
        if join_group:
            dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def run(tmp, world: int, case, *args, join_group: bool = True) -> list:
    """Run ``case(rank, world, *args)`` in ``world`` spawned ranks, joined
    in one gloo group (a file store under ``tmp``) unless ``join_group`` is
    False; returns what each rank returned, in rank order."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    mp.spawn(_entry, args=(world, tmp, case, args, join_group),
             nprocs=world, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _mesh(shape):
    from spectrobot_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(shape, "cpu")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def collective_fn(x, A, mesh):
    """A function through all three collectives: psum over (ray, nu), a
    ring shift over nu and an all_gather over ray of l = sin(A_rank x)."""
    from spectrobot_tpu_torch.parallel import collectives as C
    r = (mesh.coord["ray"] * mesh.shape["line"] + mesh.coord["line"]) \
        * mesh.shape["nu"] + mesh.coord["nu"]
    loc = torch.sin(A[r] @ x)
    s = C.psum(loc * loc, mesh, ("ray", "nu"))
    sh = C.ring_shift(loc, mesh, "nu", 1)
    g = C.all_gather(loc, mesh, "ray", 0)
    return torch.cat([s, sh * s, g])


def collectives_case(rank, world, shape, A, x, ct, xs):
    mesh = _mesh(shape)
    A, x, ct, xs = (torch.as_tensor(a) for a in (A, x, ct, xs))
    f = lambda v: collective_fn(v, A, mesh)
    xr = x.clone().requires_grad_()
    (grad,) = torch.autograd.grad(torch.sum(ct[rank] * f(xr)), xr)
    return {"value": f(x), "jacfwd": torch.func.jacfwd(f)(x),
            "vjp": grad, "vmap": torch.func.vmap(f)(xs),
            "shift_twice": _shift_back_and_forth(x, mesh)}


def _shift_back_and_forth(x, mesh):
    from spectrobot_tpu_torch.parallel.collectives import ring_shift
    return ring_shift(ring_shift(x * (1 + mesh.coord["nu"]), mesh, "nu", 1),
                      mesh, "nu", -1)


# ---------------------------------------------------------------------------
# halo
# ---------------------------------------------------------------------------


def halo_case(rank, world, nu, nu0, kl, cutoff, edges, origins, kl32):
    """Each rank's block of the halo sums: plain (float64, with and without
    per-shard origins) and through K3's wrapper (float32)."""
    from spectrobot_tpu_torch.ops.opacity import KernelLines
    from spectrobot_tpu_torch.parallel import halo
    mesh = _mesh((1, 1, world))
    k = mesh.coord["nu"]
    nu = torch.as_tensor(nu)
    nb = mesh.block(nu.shape[0], "nu")
    kl = KernelLines(*(torch.as_tensor(a) for a in kl))
    kl32 = KernelLines(*(torch.as_tensor(a) for a in kl32))
    out = {}
    skl = halo.partition_kernel_lines(kl, nu0, edges)
    out["plain"] = halo.halo_accumulate_fn(mesh, chunk=128, cutoff_cm1=cutoff)(
        nu[nb], halo.shard_lines(skl, k))
    skl_o = halo.partition_kernel_lines(kl, nu0, edges, origins=origins)
    nu_reb = halo.rebase_grid_per_shard(nu.numpy(), origins,
                                        dtype=torch.float64)
    out["origins"] = halo.halo_accumulate_fn(
        mesh, chunk=128, cutoff_cm1=cutoff, origins=origins)(
        nu_reb[nb], halo.shard_lines(skl_o, k))
    skl32 = halo.partition_kernel_lines(kl32, nu0, edges)
    f = halo.halo_accumulate_pallas_fn(mesh, nu.numpy(), skl32.nu_c.numpy(),
                                       cutoff_cm1=cutoff)
    out["kernel"] = f(nu[nb].float(), halo.shard_lines(skl32, k))
    return out


# ---------------------------------------------------------------------------
# the sharded forward
# ---------------------------------------------------------------------------


def sharded_case(rank, world, cases):
    """Each case: (name, mesh shape, nu_halo, scene dict); returns each
    rank's [R_loc, P_loc] block and its mesh coordinates."""
    from spectrobot_tpu_torch import interop
    from spectrobot_tpu_torch.ops.planck import planck_nu
    from spectrobot_tpu_torch.parallel import sharded as sh
    out = {}
    for name, shape, nu_halo, sc in cases:
        mesh = _mesh(shape)
        nu = torch.as_tensor(sc["nu"])
        lines = interop.device_lines_from_numpy(sc["lines"], device=CPU)
        cg = interop.path_cg_from_numpy(sc["cg"], device=CPU)
        nu_off = torch.as_tensor(sc["nu"] - float(lines.nu_ref))
        if nu_halo:
            dlp = sh.partition_lines_by_nu(
                lines, sc["nu"], shape[2], cutoff_cm1=sc["cutoff"],
                line_shards=shape[1], round_to=sc.get("round_to", 128))
        else:
            dlp = sh.pad_lines_for_mesh(lines, shape[1])
        is_limb = sc["T_surface"] is None
        I_bg = (None if is_limb
                else sc["emissivity"] * planck_nu(nu, sc["T_surface"]))
        st = sh.stage_sharded(mesh, nu, dlp, cg, I_bg=I_bg, nu_off=nu_off)
        f = sh.sharded_radiance_fn(
            mesh, win_grid=nu_off.numpy(), win_lines=dlp.nu0.numpy(),
            cutoff_cm1=sc["cutoff"], nu_halo=nu_halo, is_limb=is_limb,
            emissivity=sc["emissivity"])
        out[name] = (f(st.nu, st.nu_off, st.lines, st.cg, st.I_bg),
                     dict(mesh.coord), tuple(dlp.nu0.shape))
    return out


# ---------------------------------------------------------------------------
# the sharded retrieval
# ---------------------------------------------------------------------------


def mesh_retrieval_case(rank, world, cases):
    """Each case: (name, mesh shape, kwargs of make_sharded_oe, scene dict,
    y, sigma); returns (forward, (F, H, g), K) of ShardedOE, and its row
    axes."""
    from spectrobot_tpu_torch import interop
    from spectrobot_tpu_torch.data.atmosphere import MARS
    from spectrobot_tpu_torch.parallel.oe import make_sharded_oe
    from spectrobot_tpu_torch.retrieval.state import flatten_state, make_state
    out = {}
    for name, shape, kw, sc, y, sigma in cases:
        mesh = _mesh(shape)
        atm = interop.atmosphere_from_numpy(sc["atm"], device=CPU)
        lines = interop.device_lines_from_numpy(sc["lines"], device=CPU)
        t = lambda a: None if a is None else torch.as_tensor(a)
        state0 = make_state(atm, ["CO"])
        oe = make_sharded_oe(
            mesh, atm, lines, t(sc["nu"]), sc["species"], MARS,
            t(sc.get("h_t")), state_template=state0, ils_W=t(sc.get("W")),
            n_sub=2, sec_theta=t(sc.get("sec")),
            T_surface=sc.get("T_surface"), **kw)
        x0 = flatten_state(state0)[0]
        oe.bind_observation(y, sigma)
        out[name] = (oe.forward_flat(x0), oe.normal_eqs(x0),
                     oe.jacobian(x0), oe.row_axes)
    return out


def cli_case(rank, world, toml, runs):
    """``cli.main`` in each rank with torchrun's environment, once per run
    (argv, port): a new rendezvous port for each process group."""
    from spectrobot_tpu_torch import cli
    for argv, port in runs:
        os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                          LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
        assert cli.main([argv[0], toml, "--device", "cpu", *argv[1:]]) == 0
    return None


# ---------------------------------------------------------------------------
# the remote-copy halo tier (its plain versions on gloo ranks)
# ---------------------------------------------------------------------------


def dma_case(rank, world, ring_xs, halo_skl, fused):
    """Each rank's results of spectrobot_tpu_torch.dma_halo's entry points
    on the (1, 1, world) mesh: the ring exchange of its block of each
    [world * rows, cols] array of ``ring_xs`` in both directions,
    ring_halo_lines of its row of ``halo_skl`` (or None), the fused halo sum
    of its grid chunk (``fused`` = (nu, skl, cutoff)), and the ring's epoch
    (calls made)."""
    from spectrobot_tpu_torch import dma_halo
    from spectrobot_tpu_torch.ops.opacity import KernelLines
    from spectrobot_tpu_torch.parallel.peer import mesh_ring
    mesh = _mesh((1, 1, world))

    def mine(skl):
        return KernelLines(*(torch.as_tensor(a)[rank] for a in skl))

    out = {"ring": {}}
    for key, x in ring_xs.items():
        blk = torch.as_tensor(x).reshape(world, -1, x.shape[1])[rank]
        for d in (1, -1):
            out["ring"][key, d] = dma_halo.ring_exchange(mesh, "nu", d)(blk)
    if halo_skl is not None:
        out["halo_lines"] = dma_halo.ring_halo_lines(mesh, mine(halo_skl))
    nu, skl, cutoff = fused
    nu_loc = torch.as_tensor(nu)[mesh.block(len(nu), "nu")]
    out["fused"] = dma_halo.fused_halo_accumulate_fn(
        mesh, cutoff_cm1=cutoff)(nu_loc, mine(skl))
    out["epoch"] = mesh_ring(mesh).epoch
    return out
