"""The readings a cell's limits are set from: the program's numbers over
many seeds and the control's at the same inputs, in one process (the
kernels build once), one JSON line a seed.  The benchmark's own runs do
not run it.

    python -m spectrobench.calibrate --workload <cell> --seeds 1,2,3
        [--seconds S] [--control]

With ``--control`` each seed's line also holds the control's readings:
the plain reference computed with TF32 matrix products
(``reference/physics.py``) in the program's place, at the inputs the
program's window was driven with and at the states it produced.  A cell
of several cards starts its ranks as a run does; rank 0 prints.
``--control-only`` (forward traffic) reads the control alone on one card:
every atmosphere of the seed's pool through the control and the
reference at the cell's own size, no program run.  ``--fault
step_unchanged`` plants a fault in the program for the run: the LM loop's
step is computed and its state returned unchanged
(``retrieval.oe._lm_solve``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from spectrobench import manifest, run


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(prog="spectrobench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--control-only", action="store_true")
    p.add_argument("--fault", choices=("step_unchanged",), default=None)
    args = p.parse_args(argv)
    man = manifest.load(pending=True)
    if args.control_only:
        return control_only(man, args.workload,
                            [int(s) for s in args.seeds.split(",")])
    chips = int(manifest.workload(man, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("spectrobench.calibrate: not enough CUDA cards", file=sys.stderr)
        return 2
    if chips > 1 and "RANK" not in os.environ:
        return _spawn(argv, chips)
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(device)
    if args.fault == "step_unchanged":
        plant_step_unchanged()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        rec = run.run_cell(args.workload, seed, args.seconds, False, device,
                           t0, man, control=args.control)
        if rec["check"] is None:
            continue
        print(json.dumps({"seed": seed, "units": len(rec["units"]),
                          "setup_s": rec["setup_s"],
                          "window_s": rec["window_s"],
                          "run_s": time.time() - t0,
                          "program": rec["check"]["program"],
                          "control": rec["check"]["control"],
                          "checked": rec["check"]["checked"]}), flush=True)
    return 0


def plant_step_unchanged() -> None:
    """The LM step computed as ever, the state returned unchanged."""
    from spectrobot_tpu_torch.retrieval import oe
    real = oe._lm_solve

    def unchanged(x, *a):
        _, dx, d2 = real(x, *a)
        return oe._host(x), dx, d2
    oe._lm_solve = unchanged


def control_only(man, cell: str, seeds) -> int:
    """The control's rad_gap on each seed's pool of a forward cell, on
    the first card."""
    import tempfile

    import numpy as np

    from spectrobench.inputs import make_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    w = manifest.workload(man, cell)
    traffic = manifest.traffic(w["traffic"])
    if traffic["kind"] != "forward":
        raise ValueError("--control-only reads forward cells")
    dev = torch.device("cuda", 0)
    for seed in seeds:
        t0 = time.time()
        with tempfile.TemporaryDirectory(prefix="spectrobench-") as work:
            inp = make_inputs(manifest.config_path(man, w["config"]),
                              traffic, seed, work)
            gap = 0.0
            for a in inp.pool:
                y = [inp.ref.forward(inp.scene, a["T"], a["vmr"], p, dev,
                                     torch.float64).cpu().double().numpy()
                     for p in ("float32", "tf32")]
                gap = max(gap, float(np.abs(y[1] - y[0]).max()
                                     / np.abs(y[0]).max()))
        print(json.dumps({"seed": seed, "control": {"rad_gap": gap},
                          "checked": len(inp.pool),
                          "run_s": time.time() - t0}), flush=True)
    return 0


def _spawn(argv, n) -> int:
    import subprocess
    port = run._free_port()
    procs = []
    for r in range(n):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "spectrobench.calibrate", *argv],
            env=run.rank_env(r, n, port),
            stdout=None if r == 0 else subprocess.DEVNULL,
            cwd=str(manifest.REPO)))
    codes = [p.wait() for p in procs]
    return 1 if any(codes) else 0


if __name__ == "__main__":
    raise SystemExit(main())
