"""Time the fused scene's forward and Jacobian alone (a port of the
reference's ``benchmarks/jac_kernel_bench.py``).

    python -m spectrobot_tpu_torch.jac_kernel_bench [label]
        [--device {cuda,cpu}] [--n-rep N]

Runs ``bench.bench_fused_pallas`` (2048 random lines, 8192 points, 20
rays, 32 levels, 256-channel ILS: the forward through K1, the 32-column
Jacobian through K1 and K2, timed by ``bench.chained_ms``) and prints, after
its line, one JSON line: ``label``, ``fwd_ms``, ``jac_ms``, ``total_ms``
and ``card`` (the card's name and power limit).

The reference selects its kernel variants with environment variables read
at import (``SPECTROBOT_MM_PRECISION``, ``SPECTROBOT_MERGED_DOT``,
``SPECTROBOT_Y4_MIN``), knobs of its TPU kernel with no counterpart here.
A/B runs of the port's kernels go through builds instead: ``python3
ablate_basis.py`` (K2 and K4) and ``python -m
spectrobot_tpu_torch.ablate_line_sums`` (K1, K5, K3 and the halo
kernels), each against the parent's sources.
"""

from __future__ import annotations

import argparse
import json

import torch

from spectrobot_tpu_torch import bench, cli


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spectrobot_tpu_torch.jac_kernel_bench")
    p.add_argument("label", nargs="?", default="unlabeled")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--n-rep", type=int, default=None,
                   help="chains timed (default the reference's 3)")
    args = p.parse_args(argv)
    device = cli.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = bench.bench_fused_pallas(device, args.n_rep)
    print(json.dumps({
        "label": args.label, "fwd_ms": rec["forward_s"] * 1e3,
        "jac_ms": rec["jacobian_s"] * 1e3,
        "total_ms": rec["value"] * 1e3, "card": rec["card"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
