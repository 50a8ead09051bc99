"""Weak scaling of the limb forward over growing nu meshes (a port of the
reference's ``benchmarks/scaling.py``; ``BASELINE.json:5`` asks >= 80 %
grid-points/s scaling efficiency).

    python -m spectrobot_tpu_torch.scaling [--points-per-device 2048]
        [--lines 2000] [--rays 8] [--reps 5] [--halo] [--eager]
        [--max-devices N] [--json-out PATH] [--device {cuda,cpu}]

The scene is the reference's: ``co2_15um_band(j_max=40)`` and
``random_lines(2000, 560, 780, seed=2)``, a Mars atmosphere of 21 levels to
90 km, ``--rays`` rays at 6-80 km with n_sub 2, the grid over 600-740
cm-1; float32 on the card, float64 on the CPU.  For each n in 1, 2, 4, ...
up to ``--max-devices`` (default: the cards there are; 2 on the CPU) the
tool starts n ranks with ``torch.distributed.run`` (NCCL, one card a
rank, ``cuda:LOCAL_RANK``; gloo on the CPU), each running the (1, 1, n)
mesh forward (``parallel.sharded``) on ``--points-per-device`` points of
its own: the global grid grows with n (weak scaling).  In the psum tier
every rank sums every line over its chunk (cutoff 25 cm-1); with
``--halo`` (the nu-halo tier) the lines are owned by the shard holding
their centre (``partition_lines_by_nu``, cutoff ``min(10, 0.9 140 / n)``)
and the neighbours' lines arrive by ring shifts.  The mesh forward's body
replays as one CUDA graph on the card (``parallel.graphed``); ``--eager``
issues its body op by op (``f.body``) for comparison (``--json-out``'s
``graph`` says which).  Rank 0 prints one record a size: ``n_devices``,
``grid_points``, ``halo``, ``wall_s`` (the slowest
rank's host time per forward over ``--reps`` back to back, ending in a
device synchronise), ``grid_points_per_s`` (ray grid points), and
``card``; the tool adds ``efficiency_vs_1dev`` against the 1-rank rate and
prints the records.  The single rank first prints the 1-device overhead
record (the plain ``limb_radiance`` against the (1, 1, 1) mesh forward:
what the mesh's plumbing costs on one device).  A rank that fails fails
the tool (its output shown).  ``--json-out`` writes every record under a
label that names the card, or "cpu, gloo ranks".
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from spectrobot_tpu_torch import cli
from spectrobot_tpu_torch.adjoint import card
from spectrobot_tpu_torch.data.atmosphere import MARS, mars_standard_atmosphere
from spectrobot_tpu_torch.data.synth import co2_15um_band, random_lines
from spectrobot_tpu_torch.forward.geometry import limb_path_cg
from spectrobot_tpu_torch.forward.limb import limb_radiance
from spectrobot_tpu_torch.ops.cuda_opacity import line_windows
from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist
from spectrobot_tpu_torch.parallel.mesh import (
    _free_port, finalize_multihost, initialize_multihost, make_mesh)
from spectrobot_tpu_torch.parallel.sharded import (
    partition_lines_by_nu, sharded_radiance_fn, stage_sharded)

NU_MIN, NU_MAX = 600.0, 740.0
# The psum tier's cutoff (the mesh forward's default).
PSUM_CUTOFF = 25.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dtype_for(device: torch.device) -> torch.dtype:
    return torch.float32 if device.type == "cuda" else torch.float64


def halo_cutoff(n: int) -> float:
    """The nu-halo tier's cutoff at n shards: a line's wing must reach no
    further than the next 140 / n cm-1 chunk (``scaling.py:137-139``)."""
    return min(10.0, 0.9 * (NU_MAX - NU_MIN) / n)


def scene(device, dtype, n_lines: int = 2000, n_rays: int = 8) -> tuple:
    """(lines, cg): the tool's line list and limb paths on ``device``."""
    ll = co2_15um_band(j_max=40).concat(
        random_lines(n_lines, 560.0, 780.0, seed=2))
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=dtype, device=device)
    atm = mars_standard_atmosphere(n_lev=21, z_top=90e3,
                                   device=device).to(dtype)
    h_t = torch.as_tensor(np.linspace(6e3, 80e3, n_rays), dtype=dtype,
                          device=device)
    return dl, limb_path_cg(atm, ["CO2"], h_t, MARS, n_sub=2)


def _grid(n_points: int, dl, dtype, device) -> tuple:
    nu_host = np.linspace(NU_MIN, NU_MAX, n_points)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return nu_host, t(nu_host), t(nu_host - float(dl.nu_ref))


def mesh_forward(mesh, dl, cg, n_points: int, halo: bool,
                 graph: bool = True) -> Callable:
    """The (1, 1, n) mesh forward of this rank on the global grid of
    ``n_points`` points (``sharded_radiance_fn``, or its eager body where
    ``graph`` is False): a call gives its radiances [R, n_points / n]."""
    n = mesh.shape["nu"]
    nu_host, nu, nu_off = _grid(n_points, dl, cg.u.dtype, cg.u.device)
    if halo:
        cutoff = halo_cutoff(n)
        lines = partition_lines_by_nu(dl, nu_host, n, cutoff_cm1=cutoff)
    else:
        cutoff, lines = PSUM_CUTOFF, dl
    f = sharded_radiance_fn(mesh, win_grid=nu_host - float(dl.nu_ref),
                            win_lines=lines.nu0.cpu().numpy(),
                            cutoff_cm1=cutoff, nu_halo=halo)
    g = f if graph else f.body
    st = stage_sharded(mesh, nu, lines, cg, nu_off=nu_off)
    return lambda: g(st.nu, st.nu_off, st.lines, st.cg)


def wall_s(fn: Callable, reps: int, device: torch.device) -> float:
    """Host seconds per call of ``fn`` over ``reps`` back to back after a
    warm-up, ending in a device synchronise; over a world of several ranks
    (a barrier first) the slowest rank's."""
    sync = ((lambda: torch.cuda.synchronize(device))
            if device.type == "cuda" else (lambda: None))
    fn()
    sync()
    several = dist.is_initialized() and dist.get_world_size() > 1
    if several:
        dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    dt = torch.tensor([(time.perf_counter() - t0) / reps],
                      dtype=torch.float64, device=device)
    if several:
        dist.all_reduce(dt, op=dist.ReduceOp.MAX)
    return float(dt)


def overhead_record(mesh, dl, cg, n_points: int, reps: int,
                    graph: bool = True) -> dict:
    """The 1-device overhead record (``scaling.py:94-117``): the plain
    ``limb_radiance`` against the (1, 1, 1) mesh forward (psum tier) on
    ``n_points`` points."""
    if mesh.size != 1:
        raise ValueError(f"the overhead record needs a (1, 1, 1) mesh, got "
                         f"{mesh.shape}")
    device = cg.u.device
    _, nu, nu_off = _grid(n_points, dl, cg.u.dtype, device)
    windows = line_windows(nu_off, dl.nu0, cutoff_cm1=PSUM_CUTOFF)
    t_plain = wall_s(lambda: limb_radiance(nu, dl, cg, nu_off=nu_off,
                                           windows=windows), reps, device)
    t_mesh = wall_s(mesh_forward(mesh, dl, cg, n_points, False, graph),
                    reps, device)
    return {"metric": "sharded_overhead_1dev", "t_plain_s": t_plain,
            "t_mesh_s": t_mesh, "overhead_frac": t_mesh / t_plain - 1.0,
            "card": card(device)}


def scaling_record(mesh, dl, cg, points_per_device: int, reps: int,
                   halo: bool, graph: bool = True) -> dict:
    """This world's weak-scaling record (every rank calls it; the timing
    is the slowest rank's)."""
    n = mesh.shape["nu"]
    P = points_per_device * n
    device = cg.u.device
    dt = wall_s(mesh_forward(mesh, dl, cg, P, halo, graph), reps, device)
    return {"n_devices": n, "grid_points": P, "halo": bool(halo),
            "wall_s": dt, "grid_points_per_s": P * cg.u.shape[0] / dt,
            "card": card(device)}


def _rank_main(args) -> int:
    """One rank of a ``torch.distributed.run`` world: its records on
    rank 0's stdout, one JSON line each."""
    initialize_multihost(args.device)
    try:
        mesh = make_mesh(None, args.device)
        device = mesh.device
        dl, cg = scene(device, dtype_for(device), args.lines, args.rays)
        records = []
        if mesh.size == 1:
            records.append(overhead_record(mesh, dl, cg,
                                           args.points_per_device, args.reps,
                                           not args.eager))
        records.append(scaling_record(mesh, dl, cg, args.points_per_device,
                                      args.reps, args.halo, not args.eager))
        if dist.get_rank() == 0:
            for rec in records:
                print(json.dumps(rec), flush=True)
    finally:
        finalize_multihost()
    return 0


def _spawn(n: int, args) -> list:
    """Run ``n`` ranks of this tool under ``torch.distributed.run``; returns
    rank 0's records.  A failed rank fails the tool, its output shown."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", str(n), "--master-addr", "localhost",
           "--master-port", str(_free_port()), "-m",
           "spectrobot_tpu_torch.scaling", "--as-rank",
           "--device", args.device,
           "--points-per-device", str(args.points_per_device),
           "--lines", str(args.lines), "--rays", str(args.rays),
           "--reps", str(args.reps)] + (["--halo"] if args.halo else []) \
        + (["--eager"] if args.eager else [])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout + proc.stderr)
        raise SystemExit(f"scaling: the {n}-rank run failed (exit "
                         f"{proc.returncode})")
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


def with_efficiency(records: list) -> list:
    """The records with ``efficiency_vs_1dev``: each size's rate over n
    times the 1-rank rate."""
    base: Optional[float] = None
    for rec in records:
        if "n_devices" not in rec:
            continue
        if rec["n_devices"] == 1:
            base = rec["grid_points_per_s"]
        rec["efficiency_vs_1dev"] = (None if base is None else
                                     rec["grid_points_per_s"]
                                     / (base * rec["n_devices"]))
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spectrobot_tpu_torch.scaling")
    p.add_argument("--points-per-device", type=int, default=2048)
    p.add_argument("--lines", type=int, default=2000)
    p.add_argument("--rays", type=int, default=8)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--halo", action="store_true",
                   help="the nu-halo tier (owner-shard lines and ring "
                        "shifts) instead of the line psum tier")
    p.add_argument("--eager", action="store_true",
                   help="issue the mesh forward op by op instead of "
                        "replaying it as a CUDA graph")
    p.add_argument("--max-devices", type=int, default=None,
                   help="the largest world (default: the cards there are; "
                        "2 on the CPU)")
    p.add_argument("--json-out", default=None,
                   help="also write every record to this JSON file")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--as-rank", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    device = cli.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.as_rank:
        return _rank_main(args)
    n_max = args.max_devices or (torch.cuda.device_count()
                                 if device.type == "cuda" else 2)
    sizes = [1 << k for k in range(n_max.bit_length())]
    records = []
    for n in sizes:
        new = with_efficiency(records + _spawn(n, args))[len(records):]
        for rec in new:
            print(json.dumps(rec), flush=True)
        records += new
    if args.json_out:
        label = (f"{n_max} x {card(device)}" if device.type == "cuda"
                 else "cpu, gloo ranks")
        with open(args.json_out, "w") as fh:
            json.dump({"label": label, "device": args.device,
                       "n_devices_max": n_max,
                       "points_per_device": args.points_per_device,
                       "n_lines": args.lines, "n_rays": args.rays,
                       "halo": args.halo, "graph": not args.eager,
                       "records": records}, fh, indent=2)
            fh.write("\n")
        print(f"wrote {args.json_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
