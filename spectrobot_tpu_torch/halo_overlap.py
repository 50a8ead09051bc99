"""Per-rank trace of the nu-halo tier's ring exchange against its line sums
(the port's counterpart of the reference's ``benchmarks/halo_overlap_aot.py``,
which compiles the tier for a virtual TPU topology and reads XLA's
schedule).  Here the schedule is measured: every rank runs the nu-halo mesh
forward (``parallel.sharded.sharded_radiance_fn``) under ``torch.profiler``
and splits its device events into the exchange (NCCL's send/receive
kernels eagerly, the ring kernel ``dma_ring_kernel`` in a graph replay)
and the compute (every other kernel, copy and set).

    python -m spectrobot_tpu_torch.halo_overlap [--scene {aot,slice,scaling}]
        [--ranks N] [--forwards N] [--walls N] [--designs graph,eager]
        [--json-out PATH] [--device {cuda,cpu}]

The tool starts ``--ranks`` ranks (default: the cards there are; 2 on the
CPU) with ``torch.distributed.run`` (NCCL, one card a rank; gloo on the
CPU); run under an outer ``torchrun`` it is one of its ranks.  Scenes:

- ``aot``: the reference tool's scene (``__graft_entry__._scene`` at 512
  points): 7 levels to 60 km, ``co2_15um_band(j_max=8)`` and
  ``co_fundamental(j_max=6)`` moved to 655 cm-1, 512 points over 645-690
  cm-1, tangent heights 6/14/22/30 km, n_sub 2, cutoff 20 cm-1, on the
  (1, ranks / 2, 2) mesh (the reference's (2, 2, 2) without its ray axis:
  at 4 nu shards the cutoff would exceed the shard width);
- ``slice``: ``examples/mars_limb.toml`` at full width (8192 points, 121
  lines, 20 rays) with a 10 cm-1 cutoff, on (1, 1, ranks) and, from 4
  ranks, (1, 2, ranks / 2);
- ``scaling``: ``scaling.scene`` at 2048 points a rank on (1, 1, ranks),
  the cutoff ``scaling.halo_cutoff``.

Designs (``--designs``, each a run of every mesh, in the order given):
``graph`` (the default) is the mesh function as its callers get it, whose
body replays as one CUDA graph on the card, the exchange a branch beside
the own line sum (``parallel.graphed``; eager on the CPU, where no graph
is made); ``eager`` the same body issued op by op (its ``body``).
Float32 on the card, float64 on the CPU.  For each mesh every rank runs
the forward ``--walls`` times unprofiled (``forward_wall_ms``: CUDA events
on the card, the host clock on the CPU; median and quartiles), then
``--forwards`` times in one profiler window, each forward in its own range
and ending in a synchronise, after a host wait of ``PROFILER_SETTLE_S``.
Per forward (:func:`schedule`; the reference's ``schedule`` keys with the
port's meaning): ``n_exchange_launches``; ``exchange_start_us`` and
``exchange_end_us`` from the forward's first device event;
``kernels_overlapped_in_flight_window`` (compute events that intersect an
exchange event); ``exposed_exchange_us`` (exchange time with no compute
running); ``async_pairs_emitted`` (the exchange ran on another stream than
the line sums and started before the first line sum ended); the device's
busy time, the idle share of the forward's range and the ``line``
all-reduce's device time.  Each is null where the trace holds no device
event (the CPU).  Beside them the host marks (:func:`host_marks`, from
the forward's range start on the profiler's clock): when the own line sum
began and launched its first kernel, when the exchange's issue began and
launched its kernel, when that kernel began on the device and the own
sum's last kernel ended, and the own prologue's and line sum's device
time; under a replay the graph's launch issues both, so those marks name
the replay (its range's start, the ``cudaGraphLaunch``).  Each rank also
reports its radiances against the single-device forward of the same
scene (``vs_single_device``) and, in the graph design, against the eager
body on the same inputs (``vs_eager``), the replays its forwards made and
the memory its graph's capture took (``graph``).

Rank 0 prints one JSON object: the runs by design, mesh and rank, ``traffic`` (the
reference's ``traffic_argument`` and beside it the bytes the port sends a
hop), and ``topology`` ("<n> x <card>, <power limit>" as nvidia-smi gives
them, or "cpu, gloo ranks"); ``--json-out`` also writes it there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from spectrobot_tpu_torch import cli, scaling
from spectrobot_tpu_torch.adjoint import card
from spectrobot_tpu_torch.breakdown import busy_us, window_work
from spectrobot_tpu_torch.data.atmosphere import MARS, mars_standard_atmosphere
from spectrobot_tpu_torch.data.synth import co2_15um_band, co_fundamental
from spectrobot_tpu_torch.forward.geometry import limb_path_cg
from spectrobot_tpu_torch.forward.limb import limb_radiance
from spectrobot_tpu_torch.ops.cuda_opacity import line_windows
from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist
from spectrobot_tpu_torch.parallel.graphed import (
    REPLAY_RANGE, kernel_launches)
from spectrobot_tpu_torch.parallel.mesh import (
    _TORCHRUN_ENV, finalize_multihost, initialize_multihost, make_mesh)
from spectrobot_tpu_torch.parallel.sharded import (
    PER_LINE_FIELDS, partition_lines_by_nu, sharded_radiance_fn,
    stage_sharded)

# Host seconds each profiler window waits before its forwards: windows
# that began their calls at once missed a ctypes launch in 8 of 720, those
# that waited in none (chip_smoke.py's PROFILER_SETTLE_S).
PROFILER_SETTLE_S = 0.05
N_FORWARDS = 5
N_WALLS = 20
RANGE = "halo_overlap_forward"
# The scaling scene's points a rank (scaling.py's default).
SCALING_POINTS = 2048
# The line-sum kernels (K1, K2, K3) by the names of their __global__s.
LINE_SUM_KERNELS = ("opacity_batch_kernel", "basis_batch_kernel",
                    "opacity_single_kernel")
SCHEDULE_KEYS = ("n_exchange_launches", "exchange_start_us",
                 "exchange_end_us", "kernels_overlapped_in_flight_window",
                 "exposed_exchange_us", "async_pairs_emitted", "busy_us",
                 "idle_share", "line_all_reduce_us")
SLICE_TOML = os.path.join(scaling.REPO, "examples", "mars_limb.toml")
# The host's launch calls (cudaLaunch* and cuLaunch*, which NCCL may use,
# the async copies and sets, and a graph's launch), matched to their device
# events by the profiler's correlation id.
GRAPH_LAUNCH = "cudaGraphLaunch"
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                GRAPH_LAUNCH)
# Each forward's host marks (:func:`host_marks`).
HOST_MARK_KEYS = ("host_own_sum_start_us", "host_own_sum_first_launch_us",
                  "host_exchange_issue_us", "host_exchange_launch_us",
                  "exchange_device_start_us", "own_sum_device_end_us",
                  "own_prologue_device_us", "own_line_sum_device_us",
                  "host_replay_start_us", "host_graph_launch_us")
DESIGNS = ("graph", "eager")
# The __global__ of a captured exchange (collectives.capture_exchange).
EXCHANGE_KERNEL = "dma_ring_kernel"


def traffic_argument(R_loc=10, NL=20, n_out=2, n_fields=11) -> dict:
    """Bytes moved per halo hop, per shard, per Lmax line slot (float32):
    the reference's argument (``benchmarks/halo_overlap_aot.py:100-119``),
    with its defaults (config-2 scale).

    The ring shift of raw per-line fields: each rank derives its
    per-(ray, layer) kernel inputs locally, so only the ``n_fields`` raw
    per-line arrays cross the ring.  The fused remote-copy tier
    (``dma_halo.py``) sends the kernel's precomputed inputs (nu_c,
    scale_x, y, amps), which are per-(ray, layer) because widths and
    pressure shifts depend on the layer's T and p: the payload multiplies
    by the local batch B = R_loc * NL."""
    ppermute_per_line = n_fields * 4
    dma_per_line = (3 + n_out) * R_loc * NL * 4
    return {
        "ppermute_bytes_per_line_slot": ppermute_per_line,
        "fused_dma_bytes_per_line_slot": dma_per_line,
        "dma_over_ppermute_ratio": dma_per_line / ppermute_per_line,
        "assumptions": {"R_loc": R_loc, "NL": NL, "n_out": n_out,
                        "raw_fields": n_fields},
    }


def _kind(name: str) -> str:
    """A device event's part: "exchange" (NCCL's send/receive kernel, or
    the ring kernel of a captured exchange), "all_reduce", another
    "collective", or "compute"."""
    low = name.lower()
    if EXCHANGE_KERNEL in low:
        return "exchange"
    if "nccl" not in low:
        return "compute"
    if "send" in low or "recv" in low:
        return "exchange"
    return "all_reduce" if "allreduce" in low else "collective"


def schedule(work) -> dict:
    """One forward's schedule from its device events ``work`` [(name,
    start_us, end_us, stream)] (the keys of the module docstring; every
    value None without events)."""
    if not work:
        return dict.fromkeys(SCHEDULE_KEYS)
    span = lambda ws: [(s, e) for _, s, e, _ in ws]
    exch = [w for w in work if _kind(w[0]) == "exchange"]
    comp = [w for w in work if _kind(w[0]) == "compute"]
    t0 = min(s for _, s, _, _ in work)
    out = {"n_exchange_launches": len(exch),
           "busy_us": busy_us(span(work)), "idle_share": None,
           "line_all_reduce_us": sum(e - s for n, s, e, _ in work
                                     if _kind(n) == "all_reduce")}
    if not exch:
        return {**out, "exchange_start_us": None, "exchange_end_us": None,
                "kernels_overlapped_in_flight_window": 0,
                "exposed_exchange_us": 0.0, "async_pairs_emitted": False}
    x0, x1 = min(s for _, s, _, _ in exch), max(e for _, _, e, _ in exch)
    sums = sorted((s, e, st) for n, s, e, st in comp
                  if any(k in n for k in LINE_SUM_KERNELS))
    x_streams = {st for *_, st in exch}
    emitted = bool(sums) and sums[0][2] not in x_streams and x0 < sums[0][1]
    return {**out, "exchange_start_us": x0 - t0, "exchange_end_us": x1 - t0,
            "kernels_overlapped_in_flight_window": sum(
                any(s < xe and xs < e for _, xs, xe, _ in exch)
                for _, s, e, _ in comp),
            "exposed_exchange_us": busy_us(span(exch + comp))
            - busy_us(span(comp)),
            "async_pairs_emitted": emitted}


def host_marks(events, w0: float, w1: float) -> dict:
    """One forward's host marks from its profiler events ``events`` (the
    window [w0, w1] of its range; every time from w0 on the profiler's
    clock, which the host and device events share): when the own line sum
    began (its range, ``collectives.OWN_SUM_RANGE``) and launched its first
    kernel, when the exchange's issue began (``collectives.EXCHANGE_RANGE``)
    and launched its kernel, when that kernel began on the device, when the
    own sum's last kernel ended, and the device time of the own sum's
    prologue (every kernel it launched but the line sum's) and of its line
    sum (K1, K2).  Under a replay (``graphed.REPLAY_RANGE``) one
    ``cudaGraphLaunch`` issues the exchange and the own sum: their host
    marks are the replay range's start and that launch
    (``host_replay_start_us``, ``host_graph_launch_us``), the own line sum
    is the graph's first line-sum kernel and its prologue the graph's
    compute kernels that end before that one starts.  Each is None where
    the trace lacks it (the device marks on the CPU)."""
    from torch.autograd import DeviceType

    from spectrobot_tpu_torch.parallel.collectives import (
        EXCHANGE_RANGE, OWN_SUM_RANGE)

    cpu = [e for e in events if e.device_type == DeviceType.CPU
           and w0 <= e.time_range.start <= w1]
    dev = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            dev.setdefault(e.id, []).append(e)
    rel = lambda t: None if t is None else t - w0
    first = lambda name: min((e.time_range for e in cpu if e.name == name),
                             key=lambda r: r.start, default=None)
    own, issue = first(OWN_SUM_RANGE), first(EXCHANGE_RANGE)
    replay = first(REPLAY_RANGE)
    launches = sorted((e for e in cpu if e.name.startswith(LAUNCH_CALLS)),
                      key=lambda e: e.time_range.start)
    graph = [e for e in launches if e.name.startswith(GRAPH_LAUNCH)]
    out = dict.fromkeys(HOST_MARK_KEYS)
    if replay is not None:
        out["host_replay_start_us"] = rel(replay.start)
        own = own or replay
        issue = issue or replay
    out["host_exchange_issue_us"] = rel(issue and issue.start)
    x_dev = [d for e in launches for d in dev.get(e.id, ())
             if _kind(d.name) == "exchange"]
    if x_dev:
        out["exchange_device_start_us"] = rel(min(d.time_range.start
                                                  for d in x_dev))
        out["host_exchange_launch_us"] = rel(min(
            e.time_range.start for e in launches
            if any(_kind(d.name) == "exchange" for d in dev.get(e.id, ()))))
    dur = lambda d: d.time_range.end - d.time_range.start
    is_sum = lambda d: any(k in d.name for k in LINE_SUM_KERNELS)
    kern = line = None
    if graph:
        out["host_graph_launch_us"] = rel(graph[0].time_range.start)
        out["host_own_sum_first_launch_us"] = out["host_graph_launch_us"]
        ks = [d for d in dev.get(graph[0].id, ())
              if _kind(d.name) == "compute"]
        sums = sorted((d for d in ks if is_sum(d)),
                      key=lambda d: d.time_range.start)
        if sums:
            line = [sums[0]]
            kern = line + [d for d in ks if not is_sum(d)
                           and d.time_range.end <= sums[0].time_range.start]
    elif own is not None:
        mine = [e for e in launches
                if own.start <= e.time_range.start <= own.end]
        if mine:
            out["host_own_sum_first_launch_us"] = rel(
                mine[0].time_range.start)
        kern = [d for e in mine for d in dev.get(e.id, ())]
        line = [d for d in kern if is_sum(d)]
    if own is not None:
        out["host_own_sum_start_us"] = rel(own.start)
    if kern:
        out["own_sum_device_end_us"] = rel(max(d.time_range.end
                                               for d in kern))
        out["own_line_sum_device_us"] = sum(dur(d) for d in line)
        out["own_prologue_device_us"] = sum(dur(d) for d in kern
                                            if not is_sum(d))
    return out


def summary(forwards: list) -> dict:
    """A rank's forwards in one: the largest launch count, the fewest
    overlapped kernels, whether every forward emitted async pairs, and the
    median of every time (None where no forward has the value)."""
    def vals(k):
        return [f[k] for f in forwards if f.get(k) is not None]

    out = {}
    for k in SCHEDULE_KEYS + HOST_MARK_KEYS + ("window_us",):
        v = vals(k)
        if not v:
            out[k] = None
        elif k == "n_exchange_launches":
            out[k] = max(v)
        elif k == "kernels_overlapped_in_flight_window":
            out[k] = min(v)
        elif k == "async_pairs_emitted":
            out[k] = all(v)
        else:
            out[k] = float(np.median(v))
    return out


def _sync(device: torch.device) -> Callable:
    return ((lambda: torch.cuda.synchronize(device))
            if device.type == "cuda" else (lambda: None))


def forward_walls_ms(fn: Callable, device: torch.device, n: int) -> dict:
    """Wall time of ``n`` calls of ``fn`` (CUDA events on the card, the
    host clock on the CPU), each ending in a synchronise: median and
    quartiles [ms]."""
    walls = []
    for _ in range(n):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            walls.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            walls.append(1e3 * (time.perf_counter() - t0))
    q1, med, q3 = np.percentile(walls, [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3),
            "runs": n, "clock": ("cuda_events" if device.type == "cuda"
                                 else "host")}


def trace_forwards(fn: Callable, device: torch.device, n: int) -> list:
    """``n`` calls of ``fn`` in one profiler window, each in its own range
    and ending in a synchronise: for each, (its device events [(name,
    start_us, end_us, stream)] within its range, the range's length in
    us, its :func:`host_marks`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda, sync = device.type == "cuda", _sync(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        time.sleep(PROFILER_SETTLE_S)
        for i in range(n):
            with record_function(f"{RANGE}_{i}"):
                fn()
                sync()
    events = prof.events()
    dev = lambda e: e.device_type == DeviceType.CUDA
    streams = sorted({e.device_resource_id for e in events if dev(e)})
    out = []
    for i in range(n):
        work = []
        for st in streams:
            found, _ = window_work([e for e in events if not dev(e)
                                    or e.device_resource_id == st],
                                   f"{RANGE}_{i}")
            work += [(name, s, e, st) for name, s, e in found if s < e]
        _, (w0, w1) = window_work(events, f"{RANGE}_{i}", cuda=False)
        out.append((work, w1 - w0, host_marks(events, w0, w1)))
    return out


def traced_launches(fn: Callable, device: torch.device) -> tuple:
    """(launches, out): one call of ``fn`` traced (:func:`trace_forwards`),
    the launches of each counted kernel read from its device events
    (``graphed.kernel_launches``), and what the call returned."""
    outs = []
    ((work, _, _),) = trace_forwards(lambda: outs.append(fn()), device, 1)
    return kernel_launches([name for name, *_ in work]), outs[0]


def measure(fn: Callable, device: torch.device, n_forwards: int = N_FORWARDS,
            n_walls: int = N_WALLS) -> dict:
    """One rank's measurements of the warm forward ``fn`` (the module
    docstring): ``forward_wall_ms``, ``forwards`` (each one's schedule)
    and their ``summary``."""
    for _ in range(2):
        fn()
    _sync(device)()
    walls = forward_walls_ms(fn, device, n_walls)
    forwards = []
    for work, window_us, marks in trace_forwards(fn, device, n_forwards):
        f = {**schedule(work), **marks, "window_us": window_us}
        if f["busy_us"] is not None:
            f["idle_share"] = 1.0 - f["busy_us"] / window_us
        forwards.append(f)
    return {"forward_wall_ms": walls, "summary": summary(forwards),
            "forwards": forwards}


class Scene(NamedTuple):
    nu_host: np.ndarray       # [P] the global grid, float64
    lines: object             # DeviceLines, sorted
    cg: object                # PathCG of the rays
    cutoff_cm1: float
    meshes: list              # the (ray, line, nu) shapes to run


def make_scene(name: str, device: torch.device, world: int) -> Scene:
    """The scene ``name`` (the module docstring) for ``world`` ranks."""
    dtype = scaling.dtype_for(device)
    if name == "aot":
        if world % 2:
            raise ValueError(f"the aot scene runs 2 nu shards: an even "
                             f"number of ranks, not {world}")
        atm = mars_standard_atmosphere(n_lev=7, z_top=60e3,
                                       device=device).to(dtype)
        co = co_fundamental(j_max=6)
        co.nu0[:] = co.nu0 - 2143.27 + 655.0
        dl = device_lines_from_linelist(co2_15um_band(j_max=8).concat(co),
                                        [(2, 1), (5, 1)], dtype=dtype,
                                        device=device)
        h_t = torch.as_tensor([6e3, 14e3, 22e3, 30e3], dtype=dtype,
                              device=device)
        cg = limb_path_cg(atm, ["CO2", "CO"], h_t, MARS, n_sub=2)
        return Scene(np.linspace(645.0, 690.0, 512), dl, cg, 20.0,
                     [(1, world // 2, 2)])
    if name == "slice":
        cfg = cli.load_config(SLICE_TOML, {"compute.cutoff_cm1": "10"})
        sc = cli.build_scene(cfg, device)
        g = cfg.grid
        cg = limb_path_cg(sc.atm.to(sc.nu.dtype), sc.species_names, sc.h_t,
                          sc.planet, cfg.geometry.n_sub)
        meshes = [(1, 1, world)] + ([(1, 2, world // 2)]
                                    if world >= 4 and world % 2 == 0 else [])
        return Scene(np.linspace(g.nu_min, g.nu_max, g.n_points), sc.lines,
                     cg, cfg.compute.cutoff_cm1, meshes)
    if name == "scaling":
        dl, cg = scaling.scene(device, dtype)
        P = SCALING_POINTS * world
        return Scene(np.linspace(scaling.NU_MIN, scaling.NU_MAX, P), dl, cg,
                     scaling.halo_cutoff(world), [(1, 1, world)])
    raise ValueError(f"no scene {name!r} (aot, slice or scaling)")


def halo_forward(mesh, sc: Scene) -> tuple:
    """(call, f, lines_loc): this rank's nu-halo mesh function of the scene
    (``sharded_radiance_fn``), ``call(g)`` which calls ``f`` or its body
    ``f.body`` on the rank's staged inputs (its [R_loc, P_loc] radiances),
    and its line slice."""
    dl, cg = sc.lines, sc.cg
    lines = partition_lines_by_nu(dl, sc.nu_host, mesh.shape["nu"],
                                  cutoff_cm1=sc.cutoff_cm1,
                                  line_shards=mesh.shape["line"])
    nu_off = sc.nu_host - float(dl.nu_ref)
    t = lambda a: torch.as_tensor(a, dtype=cg.u.dtype, device=cg.u.device)
    f = sharded_radiance_fn(mesh, win_grid=nu_off,
                            win_lines=lines.nu0.cpu().double().numpy(),
                            cutoff_cm1=sc.cutoff_cm1, nu_halo=True)
    st = stage_sharded(mesh, t(sc.nu_host), lines, cg, nu_off=t(nu_off))
    return (lambda g: g(st.nu, st.nu_off, st.lines, st.cg)), f, st.lines


def single_device_block(mesh, sc: Scene) -> torch.Tensor:
    """This rank's [R_loc, P_loc] block of the single-device forward."""
    dl, cg = sc.lines, sc.cg
    t = lambda a: torch.as_tensor(a, dtype=cg.u.dtype, device=cg.u.device)
    nu_off = t(sc.nu_host - float(dl.nu_ref))
    I = limb_radiance(t(sc.nu_host), dl, cg, nu_off=nu_off,
                      cutoff_cm1=sc.cutoff_cm1,
                      windows=line_windows(nu_off, dl.nu0,
                                           cutoff_cm1=sc.cutoff_cm1))
    return I[mesh.block(I.shape[0], "ray"), mesh.block(I.shape[1], "nu")]


def message_bytes(lines_loc) -> int:
    """The bytes this rank sends a hop: its line slice's per-line fields,
    which the nu-halo tier sends in two messages (reals, integers)."""
    return sum(getattr(lines_loc, f).numel()
               * getattr(lines_loc, f).element_size()
               for f in PER_LINE_FIELDS)


def graph_record(f, I: torch.Tensor, eager) -> dict:
    """The graph design's record of the mesh function ``f`` (a
    ``GraphedBody``): the replays its calls made, its graphs and the
    memory their captures took, and its radiances ``I`` against the eager
    body's ``eager`` on the same inputs."""
    graphs = getattr(f, "graphs", {})
    return {"replays": getattr(f, "replays", 0), "graphs": len(graphs),
            "pool_bytes": sum(g.pool_bytes for g in graphs.values()),
            "vs_eager": {"max_abs_diff": float((I - eager).abs().max()),
                         "bit_equal": bool(torch.equal(I, eager))}}


def run_mesh(mesh, sc: Scene, device: torch.device, n_forwards: int,
             n_walls: int, design: str = "graph") -> dict:
    """Every rank's measurements of the scene on ``mesh`` in ``design``
    (gathered on every rank) and the run's shapes."""
    call, f, lines_loc = halo_forward(mesh, sc)
    g = f if design == "graph" else f.body
    rec = measure(lambda: call(g), device, n_forwards, n_walls)
    I = call(g)
    if design == "graph":
        rec["graph"] = graph_record(f, I, call(f.body))
    I = I.double()
    ref = single_device_block(mesh, sc).double()
    d = (I - ref).abs()
    rec.update(rank=dist.get_rank(), coord=dict(mesh.coord),
               vs_single_device={
                   "max_abs_err": float(d.max()),
                   "max_abs": float(ref.abs().max()),
                   # max |d| / (|ref| + max |ref|): <= r is assert_allclose
                   # with rtol = r, atol = r max |ref|
                   "worst_ratio": float((d / (ref.abs()
                                              + ref.abs().max())).max())})
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, rec)
    L = int(lines_loc.nu0.shape[0])
    sent = message_bytes(lines_loc)
    return {"design": design, "mesh": list(mesh.shape.values()),
            "n_points": int(sc.nu_host.shape[0]),
            "n_lines": int(sc.lines.nu0.shape[0]),
            "n_rays": int(sc.cg.u.shape[0]),
            "cutoff_cm1": sc.cutoff_cm1, "line_slots_per_rank": L,
            "port_traffic": {"messages_per_hop": 2, "bytes_per_hop": sent,
                             "bytes_per_line_slot": sent / L},
            "ranks": ranks}


def topology(device: torch.device, n: int) -> str:
    return (f"{n} x {card(device)}" if device.type == "cuda"
            else "cpu, gloo ranks")


def _rank_main(args) -> int:
    """One rank: rank 0 prints the JSON (and writes ``--json-out``)."""
    initialize_multihost(args.device)
    try:
        world = dist.get_world_size()
        device = (torch.device("cuda", torch.cuda.current_device())
                  if args.device == "cuda" else torch.device("cpu"))
        sc = make_scene(args.scene, device, world)
        designs = args.designs.split(",")
        runs = []
        for shape in sc.meshes:
            mesh = make_mesh(shape, args.device)
            runs += [run_mesh(mesh, sc, device, args.forwards, args.walls,
                              design) for design in designs]
        if dist.get_rank() == 0:
            out = {"tool": "halo_overlap", "scene": args.scene,
                   "topology": topology(device, world),
                   "device": args.device, "n_ranks": world,
                   "forwards_traced": args.forwards, "runs": runs,
                   "traffic": {"config2_scale": traffic_argument(),
                               "port": [{"mesh": r["mesh"],
                                         **r["port_traffic"]}
                                        for r in runs
                                        if r["design"] == designs[0]]}}
            print(json.dumps(out), flush=True)
            if args.json_out:
                with open(args.json_out, "w") as fh:
                    json.dump(out, fh, indent=1)
                    fh.write("\n")
    finally:
        finalize_multihost()
    return 0


def _spawn(n: int, argv: list) -> int:
    """Run this tool's ``argv`` in ``n`` ranks under
    ``torch.distributed.run``; rank 0's output is passed on.  A failed
    rank fails the tool, its output shown."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), "-m",
           "spectrobot_tpu_torch.halo_overlap", *argv]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [scaling.REPO] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout + proc.stderr)
        raise SystemExit(f"halo_overlap: the {n}-rank run failed (exit "
                         f"{proc.returncode})")
    sys.stdout.write(proc.stdout)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(prog="spectrobot_tpu_torch.halo_overlap")
    p.add_argument("--scene", choices=("aot", "slice", "scaling"),
                   default="aot")
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks to start (default: the cards there are; 2 on "
                        "the CPU); ignored under an outer torchrun")
    p.add_argument("--forwards", type=int, default=N_FORWARDS,
                   help="forwards traced a mesh")
    p.add_argument("--walls", type=int, default=N_WALLS,
                   help="unprofiled forwards timed a mesh")
    p.add_argument("--designs", default="graph",
                   help="comma-separated designs to run in turn on every "
                        f"mesh, of {', '.join(DESIGNS)} (default: graph)")
    p.add_argument("--json-out", default=None,
                   help="also write the JSON object to this file")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    bad = [d for d in args.designs.split(",") if d not in DESIGNS]
    if bad:
        p.error(f"no design {bad[0]!r} ({', '.join(DESIGNS)})")
    device = cli.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if all(k in os.environ for k in _TORCHRUN_ENV):
        return _rank_main(args)
    n = args.ranks or (torch.cuda.device_count() if device.type == "cuda"
                       else 2)
    return _spawn(n, argv)


if __name__ == "__main__":
    raise SystemExit(main())
