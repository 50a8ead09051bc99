"""The nu ring's remote-copy halo tier (a port of ``benchmarks/dma_halo.py``).

The reference keeps this tier out of production: it measured it on the TPU
against the nu-halo tier of ``parallel/sharded.py`` (ppermute, here
``parallel.collectives.ring_shift``) and kept the module for the tests of
its semaphore protocol, the one place of the repo where races are
possible.  The port does the same: nothing in the CLI reaches it.  Its
kernels (``parallel/cuda_dma.py``) store into the neighbours' memory from
inside the kernel, over the peer workspace of ``parallel/peer.py``.

Each function takes a ring: a :class:`~spectrobot_tpu_torch.parallel.mesh.
Mesh` over ``nu`` (:func:`nu_ring_mesh`; every rank calls, with its own
block) or the loopback ring of ``n`` shards in one process
(``parallel.peer.loopback_ring``; the tensors hold every shard).

    torchrun --nproc_per_node=4 -m spectrobot_tpu_torch.dma_halo
        [--device {cuda,cpu}] [--dense-lines 20480] [--dense-points 16384]
        [--block-mb 64] [--missing-peer R]

measures the tier against the production one on the cards of one host:
the ring exchange of the dense case's packed line rows and of a
``--block-mb`` block per rank against ``ring_shift`` (NCCL), and the fused
halo accumulation of ``bench.py:bench_kernel``'s dense shape at a
``CUTOFF_CM1`` cutoff against ``parallel/halo.py:halo_accumulate_pallas_fn``
(K3 and NCCL ring shifts), each timed over ``REPEATS`` calls; every result
is checked (the rings bit-equal, the fused sum within K1's
budget of the single-card plain sum).  Rank 0 prints one JSON line.  With
``--missing-peer R`` rank R never launches: its neighbours' kernels must
end in a CUDA error within ``parallel.peer.TIMEOUT_S``, not hang (exit 3).
``--device cpu`` runs the plain versions on gloo ranks (no times).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from spectrobot_tpu_torch.ops.opacity import KernelLines
from spectrobot_tpu_torch.parallel import cuda_dma
from spectrobot_tpu_torch.parallel.cuda_dma import (
    fused_halo_accumulate_lines, ring_exchange_cuda)
from spectrobot_tpu_torch.parallel.halo import (
    ShardedKernelLines, pack_lines, unpack_lines)
from spectrobot_tpu_torch.parallel.mesh import (
    finalize_multihost, initialize_multihost, make_mesh)
from spectrobot_tpu_torch.parallel import peer
from spectrobot_tpu_torch.parallel.peer import TIMEOUT_S, Ring, mesh_ring

# K1's parity budget (tests/test_pallas_opacity.py:90): |err| <= RTOL |ref|
# + ATOL_REL max|ref|.
RTOL, ATOL_REL = 3e-5, 1e-6
NVLINK_BYTES_S = 450e9      # one direction between two H100s (data sheet)
# The dense case's line cutoff [cm-1], and the timed calls of each route.
CUTOFF_CM1 = 10.0
REPEATS = 10


def nu_ring_mesh(device_type: str = "cuda"):
    """The 1-D ``nu`` ring over every rank of this run (torchrun's, or this
    process alone): the tier's deployment."""
    initialize_multihost(device_type)
    return make_mesh((1, 1, dist.get_world_size()), device_type)


def _ring(ring) -> Ring:
    return ring if isinstance(ring, Ring) else mesh_ring(ring)


def ring_exchange(ring, axis: str = "nu", direction: int = 1):
    """f(x) -> each shard's neighbour block of x (direction=+1: each shard
    receives its LEFT neighbour's block).  On a mesh ``x`` is this rank's
    2-D block; on the loopback the whole [n * rows, cols] array, cut into
    the shards' blocks along its first axis.  One launch per call."""
    if axis != "nu":
        raise ValueError(f"the ring runs over the nu axis, not {axis!r}")
    r = _ring(ring)

    def f(x: torch.Tensor) -> torch.Tensor:
        if not r.loopback:
            return ring_exchange_cuda(r, x, direction)
        if x.dim() != 2 or x.shape[0] % r.n != 0:
            raise ValueError(f"x must be [{r.n} * rows, cols], got "
                             f"{tuple(x.shape)}")
        blocks = x.reshape(r.n, x.shape[0] // r.n, x.shape[1])
        return ring_exchange_cuda(r, blocks.contiguous(),
                                  direction).reshape(x.shape)

    return f


def ring_halo_lines(ring, skl):
    """The line halo by the ring exchange: (from_left, from_right), each
    shard's neighbour lines.  On the loopback ``skl`` is the
    ``ShardedKernelLines`` of every shard and so are the results; on a mesh
    it is this rank's ``KernelLines`` (``parallel.halo.shard_lines``).  The
    four fields travel packed as one [3 + n_out, L] block: two launches
    (one per direction) where the reference makes eight."""
    r = _ring(ring)
    packed = pack_lines(KernelLines(*skl[:4]))
    out = []
    for direction in (1, -1):
        got = unpack_lines(ring_exchange_cuda(r, packed, direction))
        out.append(ShardedKernelLines(*got[:4]) if r.loopback
                   else KernelLines(*got[:4]))
    return out[0], out[1]


def fused_halo_accumulate_fn(ring, *, cutoff_cm1: Optional[float] = 25.0):
    """f(nu_grid, skl) -> [n_out, P]: the fused halo, one launch per call
    (``parallel.cuda_dma.fused_halo_accumulate_lines``: on the card the
    kernel reads the line rows where they are and writes the grid's
    layout).  On the loopback ``nu_grid`` is the whole grid and ``skl``
    the ``ShardedKernelLines`` of every shard; on a mesh ``nu_grid`` is
    this rank's chunk, ``skl`` its ``KernelLines``, and the result its
    [n_out, P_loc] block."""
    r = _ring(ring)

    def apply(nu_grid: torch.Tensor, skl) -> torch.Tensor:
        lines = KernelLines(*skl[:4])
        if not r.loopback:
            return fused_halo_accumulate_lines(r, nu_grid, lines,
                                               cutoff_cm1=cutoff_cm1)
        if nu_grid.shape[0] % r.n != 0:
            raise ValueError(f"{nu_grid.shape[0]} grid points do not split "
                             f"into {r.n} nu shards")
        return fused_halo_accumulate_lines(r, nu_grid.reshape(r.n, -1),
                                           lines, cutoff_cm1=cutoff_cm1)

    return apply


# ---------------------------------------------------------------------------
# The measurement across the cards of one host
# ---------------------------------------------------------------------------


def dense_case(device, mesh, *, n_lines: int, n_points: int):
    """``bench.py:bench_kernel``'s dense shape (random lines over 600-740
    cm-1, seed 0, T 220 K, p 300 Pa, p_self 100 Pa, two amplitude rows)
    over 640-700 cm-1, partitioned over the mesh's nu ranks at
    ``CUTOFF_CM1``.  Returns (nu_host, all lines, the partition, this
    rank's chunk and lines)."""
    from spectrobot_tpu_torch.data.lines import random_lines
    from spectrobot_tpu_torch.ops.opacity import line_kernel_inputs
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist
    from spectrobot_tpu_torch.parallel import halo

    dl = device_lines_from_linelist(random_lines(n_lines, 600.0, 740.0,
                                                 seed=0), [(2, 1)],
                                    dtype=torch.float32, device=device,
                                    nu_ref=0.0)
    kl = line_kernel_inputs(dl, 220.0, 300.0, 100.0, amp_weights=torch.ones(
        2, dl.n_lines, device=device))
    kl = KernelLines(*(a.contiguous() for a in kl[:4]))
    nu_host = np.linspace(640.0, 700.0, n_points)
    n, k = mesh.shape["nu"], mesh.coord["nu"]
    edges = halo.nu_shard_edges(nu_host, n, CUTOFF_CM1)
    skl = halo.partition_kernel_lines(kl, dl.nu0, edges)
    nu_loc = torch.as_tensor(nu_host[mesh.block(n_points, "nu")],
                             dtype=torch.float32, device=device)
    return nu_host, kl, skl, nu_loc, halo.shard_lines(skl, k)


def _times(fn, device) -> Optional[list]:
    """Device time of each of ``REPEATS`` calls after a warm-up [ms], the
    ranks in step (a barrier before each call); None on the CPU."""
    fn()
    if device.type != "cuda":
        return None
    out = []
    for _ in range(REPEATS):
        dist.barrier()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop))
    return out


def _median(t):
    return None if t is None else float(np.median(t))


def _missing_peer(ring: Ring, mesh, device, missing: int) -> int:
    """Every rank but ``missing`` runs one ring exchange; the ranks that
    wait on the missing one must end in a CUDA error.  Returns the exit
    code of this rank (3 for an error)."""
    k = mesh.coord["nu"]
    x = torch.full((64, 128), float(k), device=device)
    ring.workspace_for(x.numel())
    ring.sync_once("dma_ring")
    t0 = time.perf_counter()
    code = 0
    if k != missing:
        try:
            ring_exchange_cuda(ring, x, 1)
            torch.cuda.synchronize()
            print(f"rank {k}: the ring exchange completed in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
        except RuntimeError as e:
            print(f"rank {k}: missing peer (rank {missing}): the ring "
                  f"exchange ended in a CUDA error after "
                  f"{time.perf_counter() - t0:.3f} s: {e}", flush=True)
            code = 3
    # Hold the workspace mapped until every waiting kernel has timed out.
    time.sleep(max(0.0, 2 * TIMEOUT_S + 2 - (time.perf_counter() - t0)))
    return code


def run(device, *, n_lines=20480, n_points=16384, block_mb=64.0) -> dict:
    """The measurement on every rank of the ``nu`` ring; returns this
    rank's numbers and checks (raises on a failed check)."""
    from spectrobot_tpu_torch.ops.opacity import accumulate_plain
    from spectrobot_tpu_torch.parallel import halo
    from spectrobot_tpu_torch.parallel.collectives import ring_shift

    mesh = nu_ring_mesh(device.type)
    ring = mesh_ring(mesh)
    n, k = mesh.shape["nu"], mesh.coord["nu"]
    if device.type == "cuda":       # build before any rank waits on a peer
        peer.KERNEL.library()
        cuda_dma.KERNEL.library()
        ring.sync_once("dma_ring")
        ring.sync_once("dma_halo")
    nu_host, kl, skl, nu_loc, mine = dense_case(
        device, mesh, n_lines=n_lines, n_points=n_points)
    packed = pack_lines(mine).contiguous()
    rows = max(1, int(block_mb * 2 ** 20 / 4 / 4096))
    g = torch.Generator(device=device).manual_seed(k)
    block = torch.randn((rows, 4096), generator=g, device=device)
    out = {"rank": k, "world": n, "device": str(device)}

    for name, x in (("packed rows", packed), ("block", block)):
        for direction in (1, -1):
            got = ring_exchange_cuda(ring, x, direction)
            ref = ring_shift(x, mesh, "nu", direction)
            if not torch.equal(got, ref):
                raise RuntimeError(f"rank {k}: the ring exchange of the "
                                   f"{name} (direction {direction}) differs "
                                   f"from ring_shift")
        t_dma = _times(lambda: ring_exchange_cuda(ring, x, 1), device)
        t_nccl = _times(lambda: ring_shift(x, mesh, "nu", 1), device)
        nbytes = x.numel() * 4
        out[f"ring {name}"] = {
            "shape": list(x.shape), "bytes": nbytes, "bit_equal": True,
            "dma_ms": _median(t_dma), "ring_shift_ms": _median(t_nccl),
            "nvlink_bound_ms": 1e3 * nbytes / NVLINK_BYTES_S}

    f = fused_halo_accumulate_fn(ring, cutoff_cm1=CUTOFF_CM1)
    prod = halo.halo_accumulate_pallas_fn(mesh, nu_host,
                                          skl.nu_c.cpu().numpy(),
                                          cutoff_cm1=CUTOFF_CM1)
    got = f(nu_loc, mine)
    ref = accumulate_plain(nu_loc, kl, cutoff_cm1=CUTOFF_CM1)
    got_prod = prod(nu_loc, mine)
    errs = {}
    for name, v in (("fused", got), ("production", got_prod)):
        err = (v - ref).abs()
        budget = RTOL * ref.abs() + ATOL_REL * ref.abs().max()
        errs[name] = {"max_abs_err": float(err.max()),
                      "err_over_budget": float((err / budget).max())}
        if not bool(torch.isfinite(v).all()) or \
                errs[name]["err_over_budget"] > 1.0:
            raise RuntimeError(f"rank {k}: the {name} halo sum disagrees "
                               f"with the single-card plain sum: "
                               f"{errs[name]}")
    out["fused halo"] = {
        "lines": n_lines, "points": n_points, "cutoff": CUTOFF_CM1,
        "Lmax": int(skl.nu_c.shape[1]), "P_loc": int(nu_loc.shape[0]),
        "vs_single_card_plain": errs,
        "dma_ms": _median(_times(lambda: f(nu_loc, mine), device)),
        "production_ms": _median(_times(lambda: prod(nu_loc, mine), device))}
    ring.close()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spectrobot_tpu_torch.dma_halo")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--dense-lines", type=int, default=20480)
    p.add_argument("--dense-points", type=int, default=16384)
    p.add_argument("--block-mb", type=float, default=64.0)
    p.add_argument("--missing-peer", type=int, default=None,
                   help="this rank never launches: its neighbours' kernels "
                        "must end in an error")
    args = p.parse_args(argv)
    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch.adjoint import card

    device = cli.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.missing_peer is not None:
        if device.type != "cuda":
            raise ValueError("--missing-peer needs the cards: the plain "
                             "versions on the CPU have no peer to miss")
        # The handshakes over gloo: no NCCL watchdog races the report of
        # a trapped kernel.
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        mesh = nu_ring_mesh("cpu")
        code = _missing_peer(mesh_ring(mesh, device), mesh, device,
                             args.missing_peer)
        # A trapped kernel leaves this rank's context unusable: no teardown.
        sys.stdout.flush()
        os._exit(code)
    device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
              if device.type == "cuda" else device)
    res = run(device, n_lines=args.dense_lines, n_points=args.dense_points,
              block_mb=args.block_mb)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, res)
    if dist.get_rank() == 0:
        print(json.dumps({"card": card(device), "ranks": ranks}))
    finalize_multihost()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
