"""Adjoint (reverse-mode) benchmark of the port: analytic reverse mode
against plain autograd (a port of ``benchmarks/adjoint.py``).

    python -m spectrobot_tpu_torch.adjoint [--device {cuda,cpu}]

It takes the gradient of the chi-square-like scalar sum(I^2) with respect
to the temperature profile through the full limb forward
(``forward.limb.limb_radiance``): the gradient-descent and adjoint-retrieval
use.  Two legs on the same scene:

- ``analytic_rev`` (``analytic_jvp='rev'``): the line sum in K1, its
  gradient in K5 and a small epilogue (the plain versions on the CPU);
- ``plain_ad`` (``analytic_jvp=False``): autograd through the plain line
  sum, each ``chunk``-line slab recomputed in the backward pass.  If that
  does not fit on the card at the asked ``chunk``, the leg halves it until
  it does, and prints the one it used.

Default scene (the reference tool's): ``co2_15um_band(j_max=80)`` (161
lines over 605-731 cm-1), 8192 points over 600-750 cm-1, a 32-level Mars
atmosphere to 80 km, 10 rays at 10-70 km, n_sub 2, float32.  It prints each
leg's median wall time over ``--repeats`` warm gradients (each ending in a
device synchronise) beside its first call, the speed-up, and the max
relative gradient difference.  ``--device cuda`` (the default) raises
without a GPU.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from spectrobot_tpu_torch import cli
from spectrobot_tpu_torch.data.atmosphere import MARS, mars_standard_atmosphere
from spectrobot_tpu_torch.data.synth import co2_15um_band
from spectrobot_tpu_torch.forward.geometry import limb_path_cg
from spectrobot_tpu_torch.forward.limb import limb_radiance
from spectrobot_tpu_torch.ops.cuda_opacity import line_windows
from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist


def card(device: torch.device) -> str:
    """The device as the measurements name it: the card's name and power
    limit (nvidia-smi) on CUDA, else "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def scene_gradient(device: torch.device, *, n_points: int = 8192,
                   n_lev: int = 32, j_max: int = 80, n_rays: int = 10):
    """The tool's scene on ``device`` in float32.  Returns (grad, T0, n_lines)
    with grad(mode, **kw) -> d sum(I^2) / dT at T0, the line sum
    differentiated as ``analytic_jvp=mode`` says (keywords go to
    ``limb_radiance``)."""
    dt = torch.float32
    dl = device_lines_from_linelist(co2_15um_band(j_max=j_max), [(2, 1)],
                                    dtype=dt, device=device)
    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=80e3,
                                   device=device).to(dt)
    nu64 = np.linspace(600.0, 750.0, n_points)
    f32 = lambda a: torch.as_tensor(a, dtype=dt, device=device)
    nu, nu_off = f32(nu64), f32(nu64 - float(dl.nu_ref))
    ths = f32(np.linspace(10e3, 70e3, n_rays))
    windows = line_windows(nu_off, dl.nu0)

    def grad(mode, **kw):
        T = atm.T.detach().clone().requires_grad_()
        cg = limb_path_cg(atm.with_temperature(T), ["CO2"], ths, MARS, 2)
        I = limb_radiance(nu, dl, cg, analytic_jvp=mode, nu_off=nu_off,
                          windows=windows, **kw)
        (g,) = torch.autograd.grad(torch.sum(I * I), T)
        return g

    return grad, atm.T, dl.n_lines


def _timed(fn, device: torch.device, repeats: int):
    """(result, first-call seconds, warm wall times [s]) of ``fn``, each
    call ending in a device synchronise."""
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    out = fn()
    sync()
    first = time.perf_counter() - t0
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append(time.perf_counter() - t0)
    return out, first, np.asarray(walls)


def run(device: torch.device, *, chunk: int = 256, repeats: int = 5,
        **scene) -> dict:
    """Both legs on ``device``; prints the tool's lines and returns them as
    a dict (times in ms, the plain leg's chunk, gradients on the host)."""
    grad, _, n_lines = scene_gradient(device, **scene)
    n_points = scene.get("n_points", 8192)
    print(f"lines={n_lines}  points={n_points}  lev={scene.get('n_lev', 32)} "
          f"rays={scene.get('n_rays', 10)}  device={card(device)}")
    cuda = device.type == "cuda"
    legs = {}
    for name in ("analytic_rev", "plain_ad"):
        c = chunk
        while True:
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            fn = ((lambda: grad("rev")) if name == "analytic_rev" else
                  (lambda c=c: grad(False, chunk=c, remat=True)))
            try:
                g, first, walls = _timed(fn, device, repeats)
                break
            except torch.cuda.OutOfMemoryError:
                if name != "plain_ad" or c == 1:
                    raise
                c = max(1, c // 2)
        legs[name] = {
            "ms": 1e3 * float(np.median(walls)), "first_s": first,
            "grad": g.detach().cpu().numpy().astype(np.float64),
            "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if cuda else None),
            "chunk": c if name == "plain_ad" else None}
        extra = (f", chunk {c} of the asked {chunk}" if name == "plain_ad"
                 else "")
        peak = ("" if legs[name]["peak_gb"] is None
                else f", peak {legs[name]['peak_gb']:.2f} GB")
        print(f"{name:14s} grad: {legs[name]['ms']:8.1f} ms "
              f"(first call {first:.1f}s{peak}{extra})")
    ga, gp = legs["analytic_rev"]["grad"], legs["plain_ad"]["grad"]
    rel = float(np.max(np.abs(ga - gp)) / np.max(np.abs(gp)))
    speedup = legs["plain_ad"]["ms"] / legs["analytic_rev"]["ms"]
    print(f"speedup: {speedup:.2f}x   max rel grad diff: {rel:.2e}")
    return {"legs": legs, "speedup": speedup, "max_rel_grad_diff": rel}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spectrobot_tpu_torch.adjoint")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--n-points", type=int, default=8192)
    p.add_argument("--n-lev", type=int, default=32)
    p.add_argument("--j-max", type=int, default=80)
    p.add_argument("--n-rays", type=int, default=10)
    p.add_argument("--chunk", type=int, default=256,
                   help="line slab of the plain_ad leg (halved on the card "
                        "until it fits)")
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    device = cli.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(device, chunk=args.chunk, repeats=args.repeats,
        n_points=args.n_points, n_lev=args.n_lev, j_max=args.j_max,
        n_rays=args.n_rays)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
