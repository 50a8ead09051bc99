"""Device time by operation family for the fused scene's Jacobian or
forward (a port of the reference's ``benchmarks/trace_summary.py``).

    python -m spectrobot_tpu_torch.trace_summary [--scenario jac|forward]
        [--reps 3] [--device {cuda,cpu}]

Builds ``bench.fused_scene`` (2048 random lines, 8192 points, 20 rays, 32
levels, 256-channel ILS; the forward through K1, the 32-column Jacobian
through K1 and K2), calls it once warm, then records ``--reps`` calls
(each ending in a device synchronise) in one window with
``utils.profiling.trace``, which writes the Chrome trace
``spectrobot_trace/trace.json`` under the temporary directory.  It prints the card's name and power limit, the
device total per call and the 15 largest families: the device work
aggregated by name with template arguments, argument lists and trailing
digits stripped (:func:`family`).  A family with at least
``LOOP_LAUNCHES`` launches a call and more than ``LOOP_SHARE`` of the
total is flagged: that is how a per-segment Python loop shows in eager
PyTorch (the reference flags XLA's ``while`` and ``dynamic-update-slice``
pairs, its serialised loops).  On the CPU (``--device cpu``, the plain
versions, no device events) the families are the operators the window
called directly, on the host clock.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import tempfile

import torch

from spectrobot_tpu_torch import bench, cli
from spectrobot_tpu_torch.adjoint import card
from spectrobot_tpu_torch.breakdown import WINDOW, window_work
from spectrobot_tpu_torch.utils import profiling

# A family is flagged with at least this many launches a call and more
# than this share of the device total.
LOOP_LAUNCHES = 100
LOOP_SHARE = 0.05
TOP = 15


def family(name: str) -> str:
    """The family of a device kernel's (or operator's) name: without a
    leading ``void``, ``(anonymous namespace)::``, template arguments, the
    argument list (from the first parenthesis on) and trailing digits and
    dots (the reference strips ``[.\\d()]+$``)."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "")
    while True:
        t = re.sub(r"<[^<>]*>", "", s)
        if t == s:
            break
        s = t
    s = s.split("(", 1)[0].strip()
    return re.sub(r"[.\d]+$", "", s).strip() or name


def summarize(work, n_reps: int) -> list:
    """The device work ``[(name, start_us, end_us)]`` of ``n_reps`` calls
    by family: [(ms per call, launches per call, family)], the largest
    first."""
    us = collections.Counter()
    count = collections.Counter()
    for name, s, e in work:
        f = family(name)
        us[f] += max(e - s, 0.0)
        count[f] += 1
    return [(t / n_reps / 1e3, count[f] / n_reps, f)
            for f, t in us.most_common()]


def flagged(row, total_ms: float) -> bool:
    """Whether a row looks like a per-segment loop (many small launches
    that add up)."""
    ms, launches, _ = row
    return launches >= LOOP_LAUNCHES and ms > LOOP_SHARE * total_ms


def capture(device, scenario: str = "jac", reps: int = 3,
            log_dir=None) -> list:
    """The summary rows of ``reps`` warm calls of the fused scene's
    ``scenario`` ("jac" or "forward") on ``device``; the Chrome trace goes
    to ``log_dir`` (``utils.profiling.trace``'s default if None)."""
    fwd_flat, jac, x0 = bench.fused_scene(device)
    fn = jac if scenario == "jac" else fwd_flat
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn(x0)
    sync()
    with profiling.trace(log_dir) as prof:
        with torch.profiler.record_function(WINDOW):
            for _ in range(reps):
                fn(x0)
                sync()
    work, _ = window_work(prof.events(), cuda=cuda)
    return summarize(work, reps)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spectrobot_tpu_torch.trace_summary")
    p.add_argument("--scenario", default="jac", choices=("jac", "forward"))
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    device = cli.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log_dir = os.path.join(tempfile.gettempdir(), "spectrobot_trace")
    rows = capture(device, args.scenario, args.reps, log_dir)
    total = sum(r[0] for r in rows)
    where = "device" if device.type == "cuda" else "host (CPU operators)"
    print(f"card: {card(device)}")
    print(f"scenario={args.scenario}  {where} total per call: "
          f"{total:.3f} ms ({args.reps} calls; Chrome trace "
          f"{os.path.join(log_dir, 'trace.json')})")
    for row in rows[:TOP]:
        ms, n, name = row
        flag = "  <-- per-segment loop?" if flagged(row, total) else ""
        print(f"{ms:10.3f} ms  x{n:8.1f}  {name[:100]}{flag}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
