"""Headline measurements of the port on one card (a port of the reference's
``bench.py``).

    python -m spectrobot_tpu_torch.bench [--device {cuda,cpu}] [--n-rep N]
        [measurement ...]

Six measurements, in the reference's order (``bench.py:541-552``), each
printing one JSON line on stdout (diagnostics go to stderr), the dense
kernel's line again at the end:

1. ``bench_limb_scan``: the Mars limb scan (``co2_15um_band(j_max=80)``,
   8192 points over 600-750 cm-1, 32 levels, 20 rays 5-70 km, a 256-channel
   ILS at 0.8 cm-1), its forward (K1) and its 32-column Jacobian (K1 + K2);
   ``limb_scan_forward_jacobian_wall_s``.
2. ``bench_fused_pallas``: the same scene with 2048 random lines;
   ``fused_pallas_forward_jacobian_wall_s``.  "pallas" in the names means
   the kernel engine (K1 and K2 here): the reference's names are kept so
   that the two packages' outputs line up.
3. ``bench_sharded_pallas``: the (1, 1, n) mesh forward over the world
   ``parallel.mesh.initialize_multihost`` makes (size 1 without
   ``torchrun``) against the single-device ``limb_radiance``;
   ``sharded_pallas_forward_wall_s``, ``vs_baseline`` = t_single / t_mesh.
4. ``bench_kernel``: the dense single state (20480 random lines, 16384
   points over 640-700 cm-1, no cutoff) through K3;
   ``voigt_opacity_dense_evals_per_s_per_chip`` = P L / t, ``vs_baseline``
   against the project's 1e9 target.
5. ``bench_roofline``: an empirical FP32 FMA ceiling (the measurement
   kernel ``csrc/fma_peak.cu``) and the dense case's required flops
   (``roofline.region_counts``); ``kernel_roofline_pct_of_fp32_peak``.
6. ``bench_production_roofline``: the fused Jacobian's required line work
   (K2's pairs by region on the scene's live states) over its measured
   time; ``fused_jacobian_audit_tflops_lower_bound``, beside the share of
   ``roofline.basis_bound_ms``.

Sizes are the reference's: its TPU sizes on the card, its small sizes on
the CPU (``--device cpu``, the plain versions; no number of such a run is
a device number).  Every line holds ``metric``, ``value``, ``unit``,
``card`` (the card's name and power limit as nvidia-smi gives them, or
"cpu") and, on the card, ``device_busy_s``.  No line divides by a time
taken on another chip: ``vs_baseline`` appears only on the dense kernel
(a target) and the mesh forward (this card's own single-device time).

Timing (:func:`chained_ms`): n calls back to back, each input perturbed by
zero times the previous output's first element (so no call can start
before the previous one ended), between two CUDA events; the minimum over
repeats.  The reference chained its calls inside one jitted dispatch,
which kept the host out of its time; in eager PyTorch the events also
hold the host's dispatch gaps (a forward leaves the card idle most of its
wall time), so ``value`` is the time a user waits for, and
``device_busy_s`` (the union of the profiler's device intervals over the
same chain) the card's share of it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from spectrobot_tpu_torch import cli, roofline
from spectrobot_tpu_torch.adjoint import card
from spectrobot_tpu_torch.breakdown import WINDOW, busy_us, window_work
from spectrobot_tpu_torch.data.atmosphere import MARS, mars_standard_atmosphere
from spectrobot_tpu_torch.data.synth import co2_15um_band, random_lines
from spectrobot_tpu_torch.forward.geometry import limb_path_cg
from spectrobot_tpu_torch.forward.limb import limb_radiance
from spectrobot_tpu_torch.kernels import launch
from spectrobot_tpu_torch.ops import cuda_fma, cuda_single
from spectrobot_tpu_torch.ops.cuda_opacity import line_windows
from spectrobot_tpu_torch.ops.ils import ils_matrix
from spectrobot_tpu_torch.ops.opacity import line_kernel_inputs
from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist
from spectrobot_tpu_torch.retrieval.state import (
    build_forward, flatten_state, jacobian_fwd_chunked, make_state)

# The project's dense line-sum target (BASELINE.md: >= 1e9 evaluations a
# second a chip): a goal, not a measurement.
TARGET_EVALS_PER_S = 1.0e9
# The FMA chain's constants (the reference's): a and b keep every link a
# full FMA the compiler cannot fold.
FMA_A, FMA_B = 1.0000001, 1e-9


class Timing(NamedTuple):
    ms: float                  # per call: CUDA events (host clock on CPU)
    busy_ms: Optional[float]   # device busy per call (None on the CPU)


def _on_card(device: torch.device) -> bool:
    return device.type == "cuda"


def _clock(device: torch.device, n_iter: int, n_rep: int) -> str:
    """How a measurement was timed, for its unit string."""
    return (f"{'CUDA events' if _on_card(device) else 'host clock'} over "
            f"{n_iter} chained calls, min of {n_rep}")


def _sizes(device: torch.device, card_sizes, cpu_sizes):
    """The reference's TPU sizes on the card, its small sizes elsewhere."""
    return card_sizes if _on_card(device) else cpu_sizes


def _tensors(x) -> list:
    return [x] if isinstance(x, torch.Tensor) else [
        v for v in x if isinstance(v, torch.Tensor)]


def perturb_flat(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return x + s.to(x.dtype)


def perturb_fields(x, s: torch.Tensor):
    """``perturb_flat`` on every floating tensor of a named tuple (the
    Curtis-Godson columns of a path)."""
    return x._replace(**{
        f: v + s.to(v.dtype) for f, v in x._asdict().items()
        if isinstance(v, torch.Tensor) and v.is_floating_point()})


def chained_ms(fn: Callable, x0, perturb: Optional[Callable], n_iter: int,
               n_rep: int) -> Timing:
    """Per-call time of ``fn(x)`` [ms] (the counterpart of the reference's
    ``device_time``, ``bench.py:86``): ``n_iter`` calls back to back on the
    stream, call i + 1 on ``perturb(x_i, 0 * nan_to_num(first element of
    call i's output))``, computed on the device with no host synchronise
    (``nan_to_num`` before the zero scale: 0 * inf is nan).  On the card:
    CUDA events around the chain, the minimum over ``n_rep`` chains, and
    the device busy time per call (the union of ``torch.profiler``'s
    device intervals over one more chain, ``breakdown.busy_us``).  Why
    both: the reference's chain ran in one jitted dispatch, which kept the
    host out of its time; eager PyTorch issues every operation from the
    host, so the events hold its dispatch gaps too (a forward idles the
    card 84 % of its wall, PERF.md section 5).  The events' time is what a
    user waits for; the busy time is the card's share of it.  On the CPU:
    the host clock with no warm-up chain, and no busy time.
    ``perturb=None`` calls ``fn(x0)`` ``n_iter`` times (for a kernel whose
    time the chain's small operations would blur)."""
    (lead, *_) = _tensors(x0)
    cuda = lead.device.type == "cuda"

    def chain():
        x, out = x0, None
        for _ in range(n_iter):
            if out is not None and perturb is not None:
                s = torch.nan_to_num(out.reshape(-1)[0], nan=0.0,
                                     posinf=0.0, neginf=0.0)
                x = perturb(x, 0.0 * s)
            out = fn(x)
        return out

    if not cuda:     # no build or allocator to warm up: time at once
        walls = []
        for _ in range(n_rep):
            t0 = time.perf_counter()
            chain()
            walls.append(1e3 * (time.perf_counter() - t0) / n_iter)
        return Timing(min(walls), None)
    chain()
    torch.cuda.synchronize(lead.device)
    times = []
    for _ in range(n_rep):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        chain()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / n_iter)
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            chain()
            torch.cuda.synchronize(lead.device)
    work, _ = window_work(prof.events())
    busy = busy_us([(s, t) for _, s, t in work]) / 1e3 / n_iter
    return Timing(min(times), busy)


# The line-sum kernels whose launches a scene reports, by their labels.
LINE_SUMS = {"K1": "opacity_batch_kernel", "K2": "basis_batch_kernel",
             "K3": "opacity_single_kernel"}


def launches_of(fn: Callable, x) -> dict:
    """The line-sum kernels' launches in one call ``fn(x)``."""
    before = launch.LAUNCHES.copy()
    out = fn(x)
    for t in _tensors(out):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
    return {k: launch.LAUNCHES[g] - before[g] for k, g in LINE_SUMS.items()}


def _emit(record: dict) -> dict:
    print(json.dumps(record), flush=True)
    return record


def _s(ms: Optional[float]) -> Optional[float]:
    return None if ms is None else ms / 1e3


def _busy_s(*timings: Timing) -> Optional[float]:
    """The summed device busy time of ``timings`` [s] (None on the CPU)."""
    if any(t.busy_ms is None for t in timings):
        return None
    return sum(t.busy_ms for t in timings) / 1e3


# ---------------------------------------------------------------------------
# Scenes: (device, dtype) -> (fwd_flat, jac, x0) and the dense single state.
# ---------------------------------------------------------------------------


def _limb_scene(device, dtype, ll, n_points, n_lev, n_rays, engine=None):
    """The reference bench's limb scene on ``device`` in ``dtype``: ``ll``
    over 600-750 cm-1 on ``n_points`` points, a Mars atmosphere of
    ``n_lev`` levels to 80 km, ``n_rays`` rays at 5-70 km (n_sub 4), a
    256-channel Gaussian ILS at 0.8 cm-1 over 605-745 cm-1; the state is the
    temperature profile.  ``engine``: the line sums' (default: the
    kernels, plain on the CPU)."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=dtype, device=device)
    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=80e3,
                                   device=device).to(dtype)
    nu64 = np.linspace(600.0, 750.0, n_points)
    W = t(ils_matrix(nu64, np.linspace(605.0, 745.0, 256), 0.8))
    kw = {} if engine is None else {"engine": engine}
    fwd = build_forward(atm, dl, t(nu64), ["CO2"], MARS,
                        tangent_heights_m=t(np.linspace(5e3, 70e3, n_rays)),
                        ils_W=W, nu_off=t(nu64 - float(dl.nu_ref)), **kw)
    x0, unravel = flatten_state(make_state(atm, []))
    fwd_flat = lambda x: fwd(unravel(x))
    jac = lambda x: jacobian_fwd_chunked(fwd_flat, x, chunk=32)
    return fwd_flat, jac, x0


def limb_scan_scene(device, dtype=torch.float32, engine=None):
    """``bench_limb_scan``'s scene (``bench.py:132``): 161 lines of
    ``co2_15um_band(j_max=80)``; (8192 points, 32 levels, 20 rays) on the
    card, (1024, 8, 4) elsewhere."""
    P, n_lev, n_rays = _sizes(device, (8192, 32, 20), (1024, 8, 4))
    return _limb_scene(device, dtype, co2_15um_band(j_max=80), P, n_lev,
                       n_rays, engine)


def fused_scene(device, dtype=torch.float32, engine=None):
    """``bench_fused_pallas``'s scene (``bench.py:187``): 2048 random lines
    over 600-750 cm-1 (seed 3); (8192 points, 32 levels, 20 rays) on the
    card, (512, 6, 2) and 256 lines elsewhere."""
    P, n_lev, n_rays, L = _sizes(device, (8192, 32, 20, 2048),
                                 (512, 6, 2, 256))
    return _limb_scene(device, dtype, random_lines(L, 600.0, 750.0, seed=3),
                       P, n_lev, n_rays, engine)


def sharded_scene(device, dtype=torch.float32):
    """``bench_sharded_pallas``'s scene (``bench.py:240``): the fused
    scene's lines, grid and rays, no ILS, n_sub 4, on the (1, 1, n) mesh
    over the current world (``initialize_multihost`` first).  Returns
    (mesh_fn, cg_loc, single_fn, cg, block): ``mesh_fn(cg_loc)`` this rank's
    radiances [R, P / n], ``single_fn(cg)`` the single-device ones [R, P],
    ``block`` this rank's slice of the grid."""
    from spectrobot_tpu_torch.parallel.mesh import make_mesh
    from spectrobot_tpu_torch.parallel.sharded import (
        pad_lines_for_mesh, sharded_radiance_fn, stage_sharded)

    mesh = make_mesh(None, device.type)
    device = mesh.device
    P, n_lev, n_rays, L = _sizes(device, (8192, 32, 20, 2048),
                                 (512, 6, 2, 256))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    dl = device_lines_from_linelist(random_lines(L, 600.0, 750.0, seed=3),
                                    [(2, 1)], dtype=dtype, device=device)
    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=80e3,
                                   device=device).to(dtype)
    nu64 = np.linspace(600.0, 750.0, P)
    nu, nu_off = t(nu64), t(nu64 - float(dl.nu_ref))
    cg = limb_path_cg(atm, ["CO2"], t(np.linspace(5e3, 70e3, n_rays)), MARS,
                      4)
    lines = pad_lines_for_mesh(dl, mesh.shape["line"])
    f = sharded_radiance_fn(mesh, win_grid=nu64 - float(dl.nu_ref),
                            win_lines=lines.nu0.cpu().numpy())
    st = stage_sharded(mesh, nu, lines, cg, nu_off=nu_off)
    windows = line_windows(nu_off, dl.nu0)
    return (lambda c: f(st.nu, st.nu_off, st.lines, c), st.cg,
            lambda c: limb_radiance(nu, dl, c, nu_off=nu_off,
                                    windows=windows),
            cg, mesh.block(P, "nu"))


def dense_scene(device, dtype=torch.float32, n_points=None, n_lines=None):
    """``bench_kernel``'s dense single state (``bench.py:291-296``):
    random lines over 600-740 cm-1 (seed 0, nu_ref 0) at (220 K, 300 Pa,
    100 Pa self) with two amplitude rows of ones, on a grid over 640-700
    cm-1, every line at every point (no cutoff); 20480 lines x 16384
    points on the card, 1024 x 2048 elsewhere.  Returns (run, amps,
    (nu, kl)): ``run(amps)`` the line sum [2, P] through K3."""
    P, L = _sizes(device, (16384, 20480), (2048, 1024))
    P, L = n_points or P, n_lines or L
    dl = device_lines_from_linelist(random_lines(L, 600.0, 740.0, seed=0),
                                    [(2, 1)], dtype=dtype, device=device,
                                    nu_ref=0.0)
    kl = line_kernel_inputs(dl, 220.0, 300.0, 100.0, amp_weights=torch.ones(
        2, L, dtype=dtype, device=device))
    nu_c, sx, y, amps = (a.contiguous() for a in kl[:4])
    nu = torch.as_tensor(np.linspace(640.0, 700.0, P), dtype=dtype,
                         device=device)
    windows = line_windows(nu, dl.nu0, cutoff_cm1=None)
    run = lambda a: cuda_single.accumulate_single(
        nu, windows, nu_c, sx, y, a, cutoff_cm1=None)
    return run, amps, (nu, kl._replace(nu_c=nu_c, scale_x=sx, y=y,
                                       amps=amps))


# ---------------------------------------------------------------------------
# The six measurements.
# ---------------------------------------------------------------------------


def _forward_jacobian(metric: str, what: str, scene: Callable, device,
                      n_iter: int, n_rep: int) -> dict:
    fwd_flat, jac, x0 = scene(device)
    t0 = time.perf_counter()
    counts = {"forward": launches_of(fwd_flat, x0),
              "jacobian": launches_of(jac, x0)}
    print(f"{what}: first forward + Jacobian {time.perf_counter() - t0:.1f}"
          f" s; launches per call {json.dumps(counts)}", file=sys.stderr)
    t_fwd = chained_ms(fwd_flat, x0, perturb_flat, n_iter, n_rep)
    t_jac = chained_ms(jac, x0, perturb_flat, n_iter, n_rep)
    print(f"{what}: forward {t_fwd.ms:.2f} ms, Jacobian "
          f"{t_jac.ms:.2f} ms ({t_jac.ms / t_fwd.ms:.1f}x) [{n_iter} "
          f"chained, min of {n_rep}]", file=sys.stderr)
    return {"metric": metric, "value": (t_fwd.ms + t_jac.ms) / 1e3,
            "unit": f"s per forward + {int(x0.shape[0])}-column Jacobian "
                    f"({what}; {_clock(device, n_iter, n_rep)})",
            "device_busy_s": _busy_s(t_fwd, t_jac), "card": card(device),
            "forward_s": t_fwd.ms / 1e3, "jacobian_s": t_jac.ms / 1e3,
            "forward_busy_s": _s(t_fwd.busy_ms),
            "jacobian_busy_s": _s(t_jac.busy_ms),
            "n_x": int(x0.shape[0]), "launches_per_call": counts}


def bench_limb_scan(device, n_rep: Optional[int] = None) -> dict:
    """The limb scan's forward and 32-column Jacobian (``bench.py:122``)."""
    n_iter, reps = _sizes(device, (10, 3), (1, 1))
    return _emit(_forward_jacobian(
        "limb_scan_forward_jacobian_wall_s", "limb scan, 161 lines",
        limb_scan_scene, device, n_iter, n_rep or reps))


def bench_fused_pallas(device, n_rep: Optional[int] = None) -> dict:
    """The fused scene's forward and Jacobian through K1 and K2
    (``bench.py:174``)."""
    n_iter, reps = _sizes(device, (5, 3), (1, 1))
    L = _sizes(device, 2048, 256)
    return _emit(_forward_jacobian(
        "fused_pallas_forward_jacobian_wall_s",
        f"fused scene, {L} lines, kernel engine", fused_scene, device,
        n_iter, n_rep or reps))


def bench_sharded_pallas(device, n_rep: Optional[int] = None) -> dict:
    """The (1, 1, n) mesh forward against the single-device forward
    (``bench.py:225``), chained through the paths' Curtis-Godson columns
    (``bench.py:260``).  Joins or makes the process group; a group this
    call made it ends."""
    from spectrobot_tpu_torch.parallel.mesh import (
        finalize_multihost, initialize_multihost)

    made = initialize_multihost(device.type)
    try:
        mesh_fn, cg_loc, single_fn, cg, block = sharded_scene(device)
        device = cg.u.device
        I_mesh = mesh_fn(cg_loc)
        I_single = single_fn(cg)[:, block]
        err = float((I_mesh - I_single).abs().max()
                    / I_single.abs().max())
        n_iter, reps = _sizes(device, (5, 3), (1, 1))
        n_rep = n_rep or reps
        t_mesh = chained_ms(mesh_fn, cg_loc, perturb_fields, n_iter, n_rep)
        t_single = chained_ms(single_fn, cg, perturb_fields, n_iter, n_rep)
        world = torch.distributed.get_world_size()
        rank = torch.distributed.get_rank()
    finally:
        if made:
            finalize_multihost()
    print(f"sharded forward (rank {rank} of {world}): {t_mesh.ms:.2f} "
          f"ms on a (1, 1, {world}) mesh vs {t_single.ms:.2f} ms on "
          f"one device ({t_single.ms / t_mesh.ms:.2f}x); max |diff| / max "
          f"|I| {err:.3e}", file=sys.stderr)
    L = _sizes(device, 2048, 256)
    return _emit({
        "metric": "sharded_pallas_forward_wall_s", "value": t_mesh.ms / 1e3,
        "unit": f"s per mesh forward ((1, 1, {world}) mesh, {L} lines, "
                f"kernel engine; {_clock(device, n_iter, n_rep)})",
        "vs_baseline": t_single.ms / t_mesh.ms,   # 1.0 = no mesh overhead
        "device_busy_s": _s(t_mesh.busy_ms), "card": card(device),
        "single_s": t_single.ms / 1e3, "single_busy_s": _s(t_single.busy_ms),
        "max_rel_diff_vs_single": err, "rank": rank, "ranks": world})


def bench_kernel(device, n_rep: Optional[int] = None) -> dict:
    """Dense (point x line) evaluations a second through K3
    (``bench.py:285``)."""
    run, amps, (nu, kl) = dense_scene(device)
    P, L = nu.shape[0], kl.nu_c.shape[0]
    counts = launches_of(run, amps)
    n_iter, reps = _sizes(device, (20, 4), (1, 1))
    n_rep = n_rep or reps
    t = chained_ms(run, amps, perturb_flat, n_iter, n_rep)
    rate = P * L / (t.ms / 1e3)
    print(f"dense line sum: {t.ms:.3f} ms a call ({n_iter} chained, "
          f"min of {n_rep}), {P} x {L} pairs; launches per call "
          f"{json.dumps(counts)}", file=sys.stderr)
    return _emit({
        "metric": "voigt_opacity_dense_evals_per_s_per_chip", "value": rate,
        "unit": f"(spectral point x line)/s ({P} points x {L} lines, no "
                f"cutoff, K3; {_clock(device, n_iter, n_rep)})",
        "vs_baseline": rate / TARGET_EVALS_PER_S,   # the 1e9 target
        "device_busy_s": _s(t.busy_ms), "card": card(device),
        "call_s": t.ms / 1e3,
        "launches_per_call": counts})


def fma_ceiling(device, n_rep: Optional[int] = None) -> tuple:
    """(FLOP/s, FLOP/s by depth, elements): the largest FP32 FMA rate of
    the measurement kernel over chain depths 64 and 256 on 2^24 elements
    (8 and 2^14 on the CPU, where the plain chain runs)."""
    N = _sizes(device, 1 << 24, 1 << 14)
    n_iter, reps = _sizes(device, (10, 5), (1, 1))
    x = torch.ones(N, dtype=torch.float32, device=device)
    rates = {}
    for depth in _sizes(device, (64, 256), (8,)):
        t = chained_ms(lambda v: cuda_fma.fma_chain(v, FMA_A, FMA_B, depth),
                       x, None, n_iter, n_rep or reps)
        rates[depth] = 2.0 * depth * N / (t.ms / 1e3)
    return max(rates.values()), rates, N


def bench_roofline(device, kernel_rate: float,
                   n_rep: Optional[int] = None) -> dict:
    """The dense kernel's required flops a second against an empirical FP32
    FMA ceiling of this card and against the data sheet's 67 TFLOP/s
    (``bench.py:374``)."""
    peak, rates, N = fma_ceiling(device, n_rep)
    _, _, (nu, kl) = dense_scene(device)
    P, L = nu.shape[0], kl.nu_c.shape[0]
    pairs = roofline.region_counts(
        nu, kl.nu_c[None], kl.scale_x[None], kl.y[None],
        torch.ones(1, dtype=torch.bool, device=device), None)
    n_out = kl.amps.shape[0]
    flops = roofline.operations(pairs, roofline.REGION_FLOPS,
                                roofline.PIPELINE_FLOPS + 2 * n_out)
    achieved = flops * kernel_rate / (P * L)
    pct, pct_sheet = 100.0 * achieved / peak, 100.0 * achieved / \
        roofline.FP32_FLOPS
    print(f"FP32 FMA ceiling {peak / 1e12:.2f} TFLOP/s (depths "
          f"{json.dumps({k: v / 1e12 for k, v in rates.items()})}); dense "
          f"audit {flops / (P * L):.1f} flops a pair (pairs by region "
          f"{json.dumps(pairs)}) -> {achieved / 1e12:.2f} TFLOP/s = "
          f"{pct:.1f} % of the ceiling, {pct_sheet:.1f} % of the data "
          f"sheet", file=sys.stderr)
    return _emit({
        "metric": "kernel_roofline_pct_of_fp32_peak", "value": pct,
        "unit": f"% of the measured FP32 FMA ceiling ({peak / 1e12:.3f} "
                f"TFLOP/s, "
                f"{_sizes(device, 'csrc/fma_peak.cu', 'the plain chain')}); "
                f"{pct_sheet:.2f} % of the data "
                f"sheet's {roofline.FP32_FLOPS / 1e12:.0f} TFLOP/s "
                f"(required flops of the dense line sum by Humlicek "
                f"region over K3's time)",
        "card": card(device), "fma_ceiling_flops": peak,
        "fma_ceiling_by_depth": {str(k): v for k, v in rates.items()},
        "fma_elements": N,
        "pct_of_datasheet_fp32": pct_sheet,
        "achieved_flops": achieved, "pairs_by_region": pairs})


def bench_production_roofline(device, t_jac: float, n_x: int) -> dict:
    """The fused Jacobian's required line work over its measured time
    (``bench.py:453``): K2's in-cutoff pairs of the scene's live states by
    Humlicek region, each the basis flops and 2 flops per FMA of the
    contraction at R = 2 n_x rows; beside it the share of
    ``roofline.basis_bound_ms`` (a lower bound on the line sums' rate:
    the same time holds K1, the prologue and the epilogue)."""
    nu, windows, nu_c, sx, y, amps = roofline.line_sum_inputs(
        lambda e: (lambda f, _, x: f(x))(*fused_scene(device, engine=e)))
    live = amps.flatten(1).ne(0).any(1)
    pairs = roofline.region_counts(nu, nu_c, sx, y, live, windows.cutoff_cm1)
    B, L = nu_c.shape
    R = 2 * n_x
    flops = roofline.operations(pairs, roofline.REGION_FLOPS_GRAD,
                                roofline.PIPELINE_FLOPS + 8.0 * R)
    bound, _, term = roofline.basis_bound_ms(
        pairs, R, roofline.basis_batch_bytes(B, L, nu.shape[0], R))
    share = 100.0 * bound / 1e3 / t_jac
    tflops = flops / t_jac / 1e12
    print(f"fused Jacobian audit: {sum(pairs.values()) / 1e9:.3f} G pairs "
          f"in cutoff ({int(live.sum())} of {B} states live; by region "
          f"{json.dumps(pairs)}), {flops / 1e9:.1f} GFLOP at R = {R} -> >= "
          f"{tflops:.2f} TFLOP/s over the whole Jacobian; K2's bound "
          f"{bound:.3f} ms ({term}) = {share:.1f} % of it", file=sys.stderr)
    return _emit({
        "metric": "fused_jacobian_audit_tflops_lower_bound", "value": tflops,
        "unit": f"TFLOP/s of required line work (basis by Humlicek region + "
                f"2 per contraction FMA at R = {R}) over the whole measured "
                f"Jacobian time; K2's bound ({term}) is {share:.2f} % of "
                f"that time",
        "card": card(device), "bound_ms": bound, "bound_share_pct": share,
        "pairs_by_region": pairs, "audit_flops": flops})


MEASUREMENTS = ("limb_scan", "fused_pallas", "sharded_pallas", "kernel",
                "roofline", "production_roofline")


def run(device, n_rep: Optional[int] = None, only=MEASUREMENTS) -> list:
    """The measurements named in ``only``, in the reference's order, each
    printing its line, the dense kernel's last (the headline); ``roofline``
    runs the dense kernel before it as well (its rate is the numerator),
    and ``production_roofline`` the fused scene (its Jacobian time is the
    denominator).  Returns the records."""
    want = set(only)
    if "production_roofline" in want:
        want.add("fused_pallas")
    out = []
    if "limb_scan" in want:
        out.append(bench_limb_scan(device, n_rep))
    if "fused_pallas" in want:
        fused = bench_fused_pallas(device, n_rep)
        out.append(fused)
    if "sharded_pallas" in want:
        out.append(bench_sharded_pallas(device, n_rep))
    if "roofline" in want:
        rate = bench_kernel(device, n_rep)["value"]
        out.append(bench_roofline(device, rate, n_rep))
    if "production_roofline" in want:
        out.append(bench_production_roofline(device, fused["jacobian_s"],
                                             fused["n_x"]))
    if "kernel" in want:
        out.append(bench_kernel(device, n_rep))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spectrobot_tpu_torch.bench")
    p.add_argument("measurements", nargs="*", metavar="measurement",
                   help="which to run (default all): "
                        + ", ".join(MEASUREMENTS))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--n-rep", type=int, default=None,
                   help="chains timed per measurement (default the "
                        "reference's)")
    args = p.parse_args(argv)
    unknown = set(args.measurements) - set(MEASUREMENTS)
    if unknown:
        p.error(f"unknown measurement(s) {sorted(unknown)}; choose from "
                f"{', '.join(MEASUREMENTS)}")
    device = cli.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {card(device)}", file=sys.stderr)
    run(device, args.n_rep, args.measurements or MEASUREMENTS)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
