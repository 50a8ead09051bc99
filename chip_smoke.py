#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spectrobot_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:
  1. environment: a CUDA device, torch/CUDA versions, the card's name and
     power limit;
  2. build: the opacity kernel from spectrobot_tpu_torch/csrc (nvcc);
  3. K1 against its plain PyTorch version on the card, in float32: the
     forward's own limb and nadir inputs (examples/mars_limb.toml) and the
     reference bench's production scale (2048 random lines, 8192 points,
     20 rays, 32 levels), with and without the chi wing factor; all four
     Voigt tiers must occur;
  4. main path: the CLI forward of examples/mars_limb.toml through the
     kernel (its launch count must rise), radiances checked, then the same
     scene through the plain version;
  5. timings with CUDA events (median of 5 after a warm-up) and the warm
     forward wall time.
The card's name and power limit (as nvidia-smi prints them) and the kernel
table as JSON are the two lines before the last; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(REPO, "examples", "mars_limb.toml")
KERNEL_SOURCE = "spectrobot_tpu_torch/csrc/opacity_batch.cu"
REPLACES = "spectrobot_tpu/ops/pallas_opacity.py:451"
# Kernel vs plain budget (the reference's Pallas parity budget,
# tests/test_pallas_opacity.py:90): |err| <= RTOL |ref| + ATOL_REL max|ref|.
RTOL, ATOL_REL = 3e-5, 1e-6
PLAIN_STATES = 64          # live states the plain version checks at scale


class K1Case(NamedTuple):
    name: str
    nu: torch.Tensor        # [P] offset grid
    nu0: torch.Tensor       # [L] unshifted line centers (offsets)
    nu_c: torch.Tensor      # [B, L]
    sx: torch.Tensor
    y: torch.Tensor
    amps: torch.Tensor      # [B, 2, L]
    chi_b: Optional[torch.Tensor]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke failed: {what}")


def _prologue(lines, cg):
    from spectrobot_tpu_torch.forward.limb import _tau_prologue
    return [a.float().contiguous() for a in _tau_prologue(lines, cg)]


def _chi(nu_c, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0.0, 0.3, tuple(nu_c.shape)),
                           dtype=torch.float32, device=nu_c.device)


def k1_cases(device, *, n_points=None, bench_lines=2048, bench_points=8192,
             bench_rays=20):
    """The kernel inputs of phase 3 (smaller sizes for a CPU rehearsal)."""
    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch.data.atmosphere import (
        MARS, mars_standard_atmosphere)
    from spectrobot_tpu_torch.data.lines import random_lines
    from spectrobot_tpu_torch.forward.geometry import limb_path_cg
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist

    grid = {} if n_points is None else {"grid.n_points": str(n_points)}
    for mode, extra in (("limb", {}),
                        ("nadir", {"geometry.mode": "nadir",
                                   "geometry.sec_theta": "1.0,1.5,2.0"})):
        cfg = cli.load_config(SCENE, {**grid, **extra})
        scene = cli.build_scene(cfg, device)
        cg, _ = cli.path_cg(cfg, scene)
        nc, sx, y, amps = _prologue(scene.lines, cg)
        base = (scene.nu_off, scene.lines.nu0, nc, sx, y, amps)
        if mode == "limb":
            yield K1Case("limb", *base, None)
        yield K1Case(f"{mode}+chi", *base, _chi(nc, 7))

    # The reference bench's production scale (bench.py:bench_fused_pallas).
    ll = random_lines(bench_lines, 600.0, 750.0, seed=3)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=torch.float32,
                                    device=device)
    atm = mars_standard_atmosphere(n_lev=32, z_top=80e3, device=device)
    nu64 = np.linspace(600.0, 750.0, bench_points)
    nu_off = torch.as_tensor(nu64 - float(dl.nu_ref), dtype=torch.float32,
                             device=device)
    heights = torch.as_tensor(np.linspace(5e3, 70e3, bench_rays),
                              dtype=torch.float32, device=device)
    cg = limb_path_cg(atm, ["CO2"], heights, MARS, 4)
    nc, sx, y, amps = _prologue(dl, cg)
    yield K1Case("bench", nu_off, dl.nu0, nc, sx, y, amps, None)
    yield K1Case("bench+chi", nu_off, dl.nu0, nc, sx, y, amps, _chi(nc, 8))


def _states_checked(case: K1Case) -> torch.Tensor:
    """Indices of the states the plain version checks: all of them for the
    forward's own inputs, PLAIN_STATES live ones spread over the batch at
    the bench's scale."""
    B = case.nu_c.shape[0]
    if not case.name.startswith("bench"):
        return torch.arange(B, device=case.nu_c.device)
    live = torch.nonzero(case.amps.reshape(B, -1).ne(0).any(dim=1))[:, 0]
    pick = np.linspace(0, len(live) - 1, min(PLAIN_STATES, len(live)))
    return live[torch.as_tensor(pick.round().astype(np.int64),
                                device=live.device)]


def compare_k1(case: K1Case) -> dict:
    from spectrobot_tpu_torch.ops.cuda_opacity import (
        accumulate_batch, accumulate_batch_plain)

    got = accumulate_batch(case.nu, case.nu0, case.nu_c, case.sx, case.y,
                           case.amps, chi_b=case.chi_b)
    torch.cuda.synchronize()
    idx = _states_checked(case)
    sub = lambda a: None if a is None else a[idx].contiguous()
    ref = accumulate_batch_plain(case.nu, sub(case.nu_c), sub(case.sx),
                                 sub(case.y), sub(case.amps),
                                 chi_b=sub(case.chi_b))
    got = got[idx]
    check(bool(torch.isfinite(got).all()), f"{case.name}: non-finite K1")
    err = (got - ref).abs()
    bound = RTOL * ref.abs() + ATOL_REL * ref.abs().max()
    worst = float((err / bound).max())
    row = {"case": case.name, "states": int(case.nu_c.shape[0]),
           "checked": int(idx.numel()), "lines": int(case.nu_c.shape[1]),
           "points": int(case.nu.shape[0]),
           "max_abs_err": float(err.max()),
           "max_rel_err": float((err / ref.abs().clamp_min(1e-30)).max()),
           "max_ref": float(ref.abs().max()),
           "budget": f"{RTOL:g}*|ref| + {ATOL_REL:g}*max|ref|",
           "err_over_budget": worst}
    print(f"K1 vs plain: {json.dumps(row)}")
    check(worst <= 1.0, f"{case.name}: K1 disagrees with the plain version "
                        f"({worst:.3g} x the budget)")
    return row


def plain_accumulate(nu_grid, nu0_host, *args, **kw):
    """The plain line sum behind the kernel wrapper's signature (it needs
    no window table, so the unshifted centers go unused)."""
    from spectrobot_tpu_torch.ops.cuda_opacity import accumulate_batch_plain
    return accumulate_batch_plain(nu_grid, *args, **kw)


def cuda_ms(fn, n: int = 5) -> float:
    """Median device time of ``fn`` over n runs after one warm-up [ms]."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def main() -> int:
    # Phase 1: environment.
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch.kernels import build
    from spectrobot_tpu_torch.ops import cuda_opacity as co

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"card: {card}")

    # Phase 2: build from the checkout's sources.
    t0 = time.time()
    lib_path, log = build.build("opacity_batch")
    build_s = time.time() - t0
    print(f"build: {os.path.relpath(lib_path, REPO)} in {build_s:.2f} s")
    for line in log.splitlines():
        print(f"  nvcc: {line}")
    co._library()

    # Phase 3: K1 against the plain version, and the tiers it exercised.
    tiers = {name: 0 for name in co.TIERS}
    rows = {}
    cases = {}
    for case in k1_cases(dev):
        counts = co.tier_counts(case.nu, case.nu0, case.nu_c, case.sx,
                                case.y, case.amps)
        print(f"tiers {case.name}: {json.dumps(counts)}")
        for k, v in counts.items():
            tiers[k] += v
        rows[case.name] = compare_k1(case)
        cases[case.name] = case
    check(all(v > 0 for v in tiers.values()),
          f"not every Voigt tier was exercised: {tiers}")

    # Phase 4: the main path, through the CLI.
    with tempfile.TemporaryDirectory() as tmp:
        co.LAUNCHES = 0
        cli.main(["forward", SCENE, "-o", f"run.output_dir={tmp}",
                  "--device", "cuda"])
        launches = co.LAUNCHES
        with np.load(os.path.join(tmp, "forward.npz")) as out:
            I, chans = out["values"], out["nu"]
    check(launches > 0, "the CLI forward never launched the kernel")
    check(I.shape == (20, 96), f"radiance shape {I.shape} != (20, 96)")
    check(bool(np.isfinite(I).all() and (I >= 0).all()),
          "radiances not finite and non-negative")
    band = np.trapezoid(I, chans, axis=1)
    print(f"band radiance by tangent height: {band.tolist()}")
    check(bool(np.all(np.diff(band) < 0)),
          "band radiance does not fall with tangent height")
    cfg = cli.load_config(SCENE)
    scene = cli.build_scene(cfg, dev)
    I_plain = cli.run_forward(cfg, scene, plain_accumulate)
    I_plain = I_plain.cpu().numpy()
    fwd_err = float(np.abs(I - I_plain).max())
    print(f"forward kernel vs plain: max |err| {fwd_err:.3e}, "
          f"max radiance {float(np.abs(I_plain).max()):.3e}")
    np.testing.assert_allclose(I, I_plain, rtol=1e-4,
                               atol=1e-5 * np.abs(I_plain).max())

    # Phase 5: timings.
    def k1(case, fn):
        return lambda: fn(case.nu, case.nu0, case.nu_c, case.sx, case.y,
                          case.amps, chi_b=case.chi_b)

    times = {}
    for name in ("limb", "bench"):
        c = cases[name]
        times[name] = (cuda_ms(k1(c, co.accumulate_batch)),
                       cuda_ms(k1(c, plain_accumulate)))
        print(f"time {name} [{card}]: K1 {times[name][0]:.3f} ms, plain "
              f"{times[name][1]:.3f} ms ({c.nu_c.shape[0]} states x "
              f"{c.nu_c.shape[1]} lines x {c.nu.shape[0]} points)")
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        cli.run_forward(cfg, scene, co.accumulate_batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"warm forward wall [{card}]: {1e3 * np.median(walls[1:]):.2f} ms "
          f"(median of 3 after a warm-up; examples/mars_limb.toml)")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "opacity_batch", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": rows["limb"]["max_abs_err"],
        "ms": times["limb"][0], "plain_ms": times["limb"][1]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
