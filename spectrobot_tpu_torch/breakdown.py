"""Where the time goes on the card: a host/device breakdown of the
retrieval's warm forward, warm Jacobian and warm reverse gradient at the
prior of a configured scene (``cli.retrieval_problem``,
``cli.make_jacobian``).

    python -m spectrobot_tpu_torch.breakdown [cfg.toml] [-o section.key=value ...]

Default scene: ``examples/mars_limb.toml``; ``-o`` overrides its keys as
the CLI's do (e.g. acceptance config 3: the 4.3 um band with ``[nlte]``;
the (P, T) table tier: ``-o compute.use_lut=true``).  The reverse gradient
is that of the retrieval cost 1/2 |(y - y_obs) / sigma|^2 with respect to
the flat state through ``retrieval_problem(analytic_jvp='rev')`` (K1 and
K5), with y_obs = 1.01 y(x0) and sigma = 0.005 max y(x0) (the self-test
retrieval's default noise).  It prints the card's name and power limit
(as nvidia-smi gives them), then one JSON object for each of the three
calls:

- ``wall_ms``: host wall time of one call, ending in a device synchronise,
  over 20 unprofiled calls after a warm-up (median and quartiles);
- under ``torch.profiler`` over 5 calls in one window, each call
  ending in a device synchronise as the retrieval's do (it copies every
  result to the host): the window's wall time, the device's busy time (the
  union of the intervals of its kernels, copies and sets, so overlapping
  work counts once), the idle share ``1 - busy / window`` of that same
  window, and the device events per call;
- ``busy_over_unprofiled_wall``: the device busy time per call over the
  unprofiled median wall time (the profiler slows the host, so the
  profiled window's idle share is an upper bound);
- ``top_kernels``: the device work by name (kernels, copies, sets), the
  largest times per call first;
- ``peak_gb``: peak device memory of one call.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from spectrobot_tpu_torch import cli

# Calls per profiled window (and 4x as many unprofiled calls).
N_CALLS = 5
# The name of the profiled window's range.
WINDOW = "breakdown_window"
SCENE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "mars_limb.toml")


def busy_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _sync_wall_ms(fn, n: int) -> np.ndarray:
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return np.asarray(walls)


def window_work(events, window: str = WINDOW, cuda: bool = True) -> tuple:
    """The work a profiler recorded inside the range ``window`` (a
    ``torch.profiler.record_function`` around the calls): (work, (start,
    end)), ``work`` as [(name, start_us, end_us)] clipped to the window.
    With ``cuda`` the device's kernels, copies and sets (not the device
    side of a ``record_function`` range); else (a CPU run, no device
    events) the operators the window called directly, looking through
    the program's own spans (``utils.profiling.annotate``: ranges named
    ``spectrobot.*``), which are not operators."""
    from torch.autograd import DeviceType

    # The window's own range (its device-side annotation is not work).
    (win,) = [e for e in events if e.name == window
              and e.device_type == DeviceType.CPU]
    w0, w1 = win.time_range.start, win.time_range.end
    if cuda:
        found = [e for e in events if e.device_type == DeviceType.CUDA
                 and e.name != window
                 and not getattr(e, "is_user_annotation", False)]
    else:
        found, spans = [], [win]
        while spans:
            for e in spans.pop().cpu_children:
                (spans if e.name.startswith("spectrobot.")
                 else found).append(e)
    work = [(e.name, max(e.time_range.start, w0), min(e.time_range.end, w1))
            for e in found]
    return work, (w0, w1)


def measure(fn) -> dict:
    """The breakdown of ``fn`` (one warm call) described in the module
    docstring."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = N_CALLS
    walls = _sync_wall_ms(fn, 4 * n)
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(n):
                fn()
                torch.cuda.synchronize()
    work, (w0, w1) = window_work(prof.events())
    if not work:
        raise RuntimeError("the profiler recorded no device events: no "
                           "device time to report")
    busy = busy_us([(s, t) for _, s, t in work]) / n
    by_name = {}
    for name, s, t in work:
        us, count = by_name.get(name, (0.0, 0))
        by_name[name] = (us + max(t - s, 0.0), count + 1)
    window_ms = (w1 - w0) / 1e3 / n
    q1, med, q3 = np.percentile(walls, [25, 50, 75])
    return {
        "wall_ms": {"median": float(med), "q1": float(q1), "q3": float(q3),
                    "runs": int(walls.size)},
        "profiled_window_ms_per_call": window_ms,
        "device_busy_ms_per_call": busy / 1e3,
        "idle_share_profiled": 1.0 - busy / 1e3 / window_ms,
        "busy_over_unprofiled_wall": busy / 1e3 / float(med),
        "device_events_per_call": len(work) / n,
        "top_kernels": [{"name": k[:100], "ms_per_call": us / 1e3 / n,
                         "launches_per_call": count / n}
                        for k, (us, count) in sorted(
                            by_name.items(), key=lambda kv: -kv[1][0])[:8]],
        "peak_gb": peak_gb,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spectrobot_tpu_torch.breakdown")
    p.add_argument("config", nargs="?", default=SCENE)
    p.add_argument("-o", "--override", action="append", default=[],
                   metavar="SECTION.KEY=VALUE")
    args = p.parse_args(argv)
    device = cli.resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = cli.load_config(args.config, dict(
        ov.partition("=")[::2] for ov in args.override))
    engine = cli.select_engine(cfg, device)
    scene = cli.build_scene(cfg, device)
    prob = cli.retrieval_problem(cfg, scene, engine)
    rev = cli.retrieval_problem(cfg, scene, engine, analytic_jvp="rev")
    n_x = int(prob.x0.shape[0])
    jac = cli.make_jacobian(cfg, prob.fwd_flat, n_x, int(scene.nu.shape[0]),
                            device)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"breakdown: {args.config} {' '.join(args.override)}, {n_x} state "
          f"parameters, card: {card}")
    y0 = prob.fwd_flat(prob.x0).detach()
    y_obs, sigma = 1.01 * y0, 0.005 * float(y0.max())

    def gradient():
        x = rev.x0.detach().clone().requires_grad_()
        r = (rev.fwd_flat(x) - y_obs) / sigma
        return torch.autograd.grad(0.5 * torch.sum(r * r), x)[0]

    for name, fn in (("forward", lambda: prob.fwd_flat(prob.x0)),
                     ("jacobian", lambda: jac(prob.x0)),
                     ("gradient", gradient)):
        print(json.dumps({"call": name, **measure(fn)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
