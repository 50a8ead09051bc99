"""One run of one cell of the benchmark of ``spectrobot_tpu_torch``:

    python -m spectrobench --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix.  The run makes its inputs from ``--seed``, builds the program
and warms every shape its traffic uses (set-up), drives the traffic for
``--seconds`` (the window; a unit in flight at its end completes and the
window ends with it), reads the peak device memory, with ``--trace 1``
runs a few more units under the profiler, frees the program's state,
compares what the window produced with the plain reference, and prints
one JSON line last on standard output:
``{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
"checks"}``, with ``--trace 0`` the cell's end-to-end metrics and with
``--trace 1`` its per-layer metrics.  The numbers compared are also the
last lines on standard error, each beside its limit.

A cell of several cards starts one rank a card from this process
(``torch.distributed`` over a free localhost port, NCCL); rank 0 prints
the line, which this process passes on.  Without as many cards as the
cell asks for, the run fails and prints no result; so does a run whose
process holds a module of JAX or of the JAX package once the window has
closed, on any rank.  The kernels build into the program's own cache
(``spectrobot_tpu_torch/build/``); the run's files go to a temporary
directory under ``TMPDIR``; the reference's observations of a retrieval
campaign are kept in the benchmark's cache under ``XDG_CACHE_HOME``, and
the seconds set-up spends on them are left out of ``setup_s``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from spectrobench import manifest, tracing
from spectrobench.drivers import sync
from spectrobench.inputs import make_inputs

# Top-level module names the run may not hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "spectrobot_tpu")
# A run of several cards ends its ranks after this long.
RANKS_TIMEOUT_S = 1150


def forbidden_modules() -> list:
    """The modules of JAX or of the JAX package this process holds,
    compared by whole top-level names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _all_stop(stop: bool, mesh, device) -> bool:
    """Whether any rank's window is over (every rank leaves together)."""
    if mesh is None:
        return stop
    flag = torch.tensor([1.0 if stop else 0.0], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item() > 0)


def _gather(obj, mesh) -> list:
    if mesh is None:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _barrier() -> None:
    dist.barrier()


def _peak_bytes(device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, man=None, overrides=None,
             max_units=None, control: bool = False) -> dict:
    """One run of ``cell`` on ``device`` (the steps of the module
    docstring), from a process that began at ``t0`` (``time.time()``).
    Returns the record the metric readers take, with the comparison's
    numbers (``check``) on rank 0; ``overrides`` (configuration keys) and
    ``max_units`` (a cap on the window's units) serve the tests;
    ``control`` also reads the control at the same inputs."""
    from spectrobot_tpu_torch import cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    man = man or manifest.load()
    w = manifest.workload(man, cell)
    traffic = manifest.traffic(w["traffic"])
    with tempfile.TemporaryDirectory(prefix="spectrobench-") as work:
        inputs = make_inputs(manifest.config_path(man, w["config"]), traffic,
                             seed, work, overrides)
        with cli.open_mesh(inputs.cfg, device) as mesh:
            rank0 = mesh is None or dist.get_rank() == 0
            if mesh is not None:
                device = mesh.device
            driver = manifest.driver(traffic["kind"])(inputs, device, mesh)
            driver.setup()
            sync(device)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            setup_s = time.time() - t0 - driver.reference_s
            units, i = [], 0
            w0 = time.perf_counter()
            while True:
                units.append(driver.unit(i))
                i += 1
                stop = (time.perf_counter() - w0 >= seconds
                        or (max_units is not None and i >= max_units))
                if _all_stop(stop, mesh, device):
                    break
            window_s = time.perf_counter() - w0
            peak = max(_gather(_peak_bytes(device), mesh))
            traced = work_ms = None
            if trace:
                tr = tracing.trace_units(
                    driver, list(range(int(traffic["traced_units"]))), device,
                    None if mesh is None else _barrier)
                traced = _gather(tracing.summary(tr), mesh)
                if rank0:
                    traced[0] = tr
                    work_ms = tracing.count_work(inputs, tr["calls"], device)
            driver.release()
            check = None
            if rank0:
                check = driver.check(control)
                check["program"]["unconverged"] = float(sum(
                    not u.get("converged", True) for u in units))
                if control:
                    check["control"]["unconverged"] = 0.0
            if mesh is not None:
                dist.barrier()
    return {"cell": cell, "seed": seed, "setup_s": setup_s,
            "window_s": window_s, "units": units, "peak_bytes": peak,
            "trace": traced, "work": work_ms, "check": check,
            "chips": 1 if mesh is None else mesh.size,
            "device_kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu")}


def result_line(rec: dict, man: dict, trace: bool) -> dict:
    """The run's last line from its record: the cell's metrics, read by
    their files; the comparison's numbers beside their limits."""
    cell = rec["cell"]
    lim = manifest.limits(cell)
    numbers = rec["check"]["program"]
    missing = set(lim) - set(numbers)
    if missing:
        raise KeyError(f"{cell}: no reading of {sorted(missing)}")
    checks = {k: {"value": numbers[k], "limit": lim[k]} for k in lim}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    metrics = {}
    for m in manifest.metrics_for(man, cell, trace):
        value = manifest.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = int(numbers.get("unconverged", 0.0))
    device = {"platform": "gpu" if rec["device_kind"] != "cpu" else "cpu",
              "kind": rec["device_kind"], "count": rec["chips"],
              "memory_peak_bytes": rec["peak_bytes"]}
    out = {"correct": correct, "attempted": len(rec["units"]),
           "failed": failed, "metrics": metrics, "device": device}
    if trace and rec["trace"]:
        device["busy_s"] = float(np.mean([tracing.busy_s(t)
                                          for t in rec["trace"]]))
        device["window_s"] = rec["trace"][0]["window_us"] / 1e6
        out["breakdown"] = tracing.breakdown(rec["trace"][0])
    out["checks"] = checks
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, n: int, port: int) -> dict:
    """The environment of rank ``rank`` of ``n`` on this host, its
    rendezvous at ``port`` on localhost (one card a rank)."""
    return {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
            "WORLD_SIZE": str(n), "LOCAL_WORLD_SIZE": str(n),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


def spawn_ranks(argv: list, n: int, t0: float) -> int:
    """Run this command in ``n`` ranks (one card each) and pass rank 0's
    result on: its standard error after the others', then the numbers
    compared, then its last line.  A rank that fails fails the run."""
    port = _free_port()
    procs = []
    with tempfile.TemporaryDirectory(prefix="spectrobench-ranks-") as d:
        outs = []
        for r in range(n):
            out = open(os.path.join(d, f"out{r}"), "w+")
            err = open(os.path.join(d, f"err{r}"), "w+")
            outs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "spectrobench", *argv, "--t0",
                 repr(t0)], stdout=out, stderr=err,
                env=rank_env(r, n, port), cwd=str(manifest.REPO)))
        deadline = time.time() + RANKS_TIMEOUT_S
        codes = [None] * n
        while any(c is None for c in codes):
            for r, p in enumerate(procs):
                if codes[r] is None:
                    codes[r] = p.poll()
            if (any(c not in (None, 0) for c in codes)
                    or time.time() > deadline):
                break
            time.sleep(0.2)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        texts = []
        for out, err in outs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    for r in list(range(1, n)) + [0]:
        sys.stderr.write(texts[r][1])
    codes = [p.returncode for p in procs]
    if any(codes):
        print(f"spectrobench: ranks exited with {codes}", file=sys.stderr)
        return 1
    lines = texts[0][0].strip().splitlines()
    if not lines:
        print("spectrobench: rank 0 printed no result", file=sys.stderr)
        return 1
    return finish(json.loads(lines[-1]))


def holds_forbidden() -> bool:
    """Whether this process holds a forbidden module (named on standard
    error if it does)."""
    bad = forbidden_modules()
    if bad:
        print(f"spectrobench: the run's process holds {bad}; no result",
              file=sys.stderr)
    return bool(bad)


def conclude(rec: dict, man: dict, trace: bool) -> int:
    """A rank's end once its window has closed: every rank fails where its
    process holds a forbidden module; rank 0 (the one with the comparison)
    prints the result."""
    if rec["check"] is None:
        return 3 if holds_forbidden() else 0
    return finish(result_line(rec, man, trace))


def finish(result: dict) -> int:
    """Print the numbers compared on standard error and the result line on
    standard output, unless this process holds a forbidden module."""
    if holds_forbidden():
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None, t0=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(prog="spectrobench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--t0", type=float, default=None,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed is a whole number >= 0")
    t0 = args.t0 if args.t0 is not None else (t0 or time.time())
    man = manifest.load()
    chips = int(manifest.workload(man, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"spectrobench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    if chips > 1 and "RANK" not in os.environ:
        own = [a for i, a in enumerate(argv)
               if not (a == "--t0" or (i and argv[i - 1] == "--t0"))]
        return spawn_ranks(own, chips, t0)
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(device)
    rec = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device, t0, man)
    return conclude(rec, man, bool(args.trace))

