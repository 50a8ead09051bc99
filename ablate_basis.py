#!/usr/bin/env python3
"""Ablation builds of the basis contraction (K2 and K4) on one CUDA GPU.

    python3 ablate_basis.py [--parent DIR]

Each variant is built from the checkout's spectrobot_tpu_torch/csrc with
one part of csrc/basis_contract.cuh taken out by a text edit (the run
fails if an edit no longer applies):

  full      the kernels as they are;
  no_mma    the tensor-core products replaced by a fold of the A registers:
            the basis, its split, the staging and the pipeline remain;
  no_split  the split of staged rows into B fragments left out: the
            products read stale fragments.

``--parent DIR`` adds the sources under DIR/spectrobot_tpu_torch/csrc as
the variant ``parent`` (e.g. ``git archive <commit>
spectrobot_tpu_torch/csrc | tar -x -C DIR``); their C interfaces must be
the checkout's.  Cases: K2 at the slice (examples/mars_limb.toml, R = 66)
and at the bench scale (R = 66), K4 at the reference bench's dense shape
(R = 6 and 66), the inputs of chip_smoke.py.  Times: wrapper calls, CUDA
events, median of 10 after a warm-up; each case is timed over the variants
in turns, forward and then reverse order.  Prints the card's name and
power limit, then one JSON line per variant with its registers, spills and
times.  An ablated build computes wrong results by construction: only
``full`` and ``parent`` are results.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs

HEADER = "basis_contract.cuh"
EDITS = {
    "full": [],
    "no_mma": [(
        "contract_group<NT>(frag + (u & 1) * frag_n + sg * group_n, n_used,\n"
        "                           ahi, alo, acc);",
        "{ uint32_t x = 0; for (int k = 0; k < 4; ++k) for (int j = 0; "
        "j < 4; ++j) x ^= ahi[k][j] ^ alo[k][j]; acc[0][0] += "
        "__uint_as_float(x & 0x3f800000u) * 1e-30f; }")],
    "no_split": [(
        "split_rows<SG>(frag + ((u + 1) & 1) * frag_n, rows_of(u + 1), "
        "n_used);", ";")],
}
KERNELS = ("basis_batch", "basis_single")


def build_variant(name: str, src: str, kernel: str) -> tuple:
    """Compile ``kernel`` from a copy of ``src`` with the variant's edits;
    returns (name, kernel, library path, ptxas report)."""
    from spectrobot_tpu_torch.kernels import build

    d = tempfile.mkdtemp(prefix=f"ablate_{name}_")
    for f in os.listdir(src):
        shutil.copy(os.path.join(src, f), d)
    path = os.path.join(d, HEADER)
    text = open(path).read()
    for old, new in EDITS.get(name, []):
        if old not in text:
            raise RuntimeError(f"variant {name}: the edit no longer applies")
        text = text.replace(old, new)
    open(path, "w").write(text)
    lib = os.path.join(d, f"lib{kernel}.so")
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib,
                           os.path.join(d, f"{kernel}.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}/{kernel}:\n"
                           f"{proc.stderr[-3000:]}")
    return name, kernel, lib, proc.stdout + proc.stderr


def cases(dev) -> dict:
    """name -> (kernel, call(cb, cbs)): chip_smoke.py's inputs."""
    from spectrobot_tpu_torch.data.lines import random_lines
    from spectrobot_tpu_torch.ops import cuda_opacity as co
    from spectrobot_tpu_torch.ops.opacity import line_kernel_inputs
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist

    k1 = {c.name: c for c in cs.k1_cases(dev)}
    out = {}
    for seed, name in ((0, "limb"), (2, "bench")):
        c = k1[name]
        C = cs.coefficient_rows(c, cs.K2_COLUMNS, seed)
        out[f"K2 {name}, R = 66"] = ("basis_batch", (
            lambda c, C: lambda cb, cbs: cb.basis_contract_batch(
                c.nu, c.windows, c.nu_c, c.sx, c.y, *C, chi_b=c.chi_b))(c, C))
    dl = device_lines_from_linelist(random_lines(20480, 600.0, 740.0, seed=0),
                                    [(2, 1)], dtype=torch.float32,
                                    device=dev, nu_ref=0.0)
    kl = line_kernel_inputs(dl, 220.0, 300.0, 100.0,
                            amp_weights=torch.ones(2, dl.n_lines, device=dev))
    nu = torch.as_tensor(np.linspace(640.0, 700.0, 16384),
                         dtype=torch.float32, device=dev)
    dense = cs.K3Case("dense", nu, co.line_windows(nu, dl.nu0, cutoff_cm1=None),
                      *(a.contiguous() for a in kl[:4]), None)
    one = dense._replace(amps=dense.amps[:2].contiguous()).as_batch()
    for R in (6, 66):
        C = [c[0] for c in cs.coefficient_rows(one, R // 2, 200 + R)]
        out[f"K4 dense, R = {R}"] = ("basis_single", (
            lambda C: lambda cb, cbs: cbs.basis_contract_single(
                dense.nu, dense.windows, dense.nu_c, dense.sx, dense.y, *C,
                cutoff_cm1=None))(C))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_basis: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from spectrobot_tpu_torch.kernels import build
    from spectrobot_tpu_torch.ops import cuda_basis as cb
    from spectrobot_tpu_torch.ops import cuda_basis_single as cbs

    sources = {v: str(build.SOURCE_DIR) for v in EDITS}
    if args.parent:
        sources["parent"] = os.path.join(args.parent, "spectrobot_tpu_torch",
                                         "csrc")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    jobs = [(v, src, k) for v, src in sources.items() for k in KERNELS]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build_variant(*j), jobs))
    libs, rows = {}, {v: {"variant": v, "card": card} for v in sources}
    wrappers = {"basis_batch": cb, "basis_single": cbs}
    for v, kernel, path, log in built:
        libs[v, kernel] = wrappers[kernel].KERNEL.bind(path)
        rows[v][f"{kernel} registers"] = [
            int(r) for r in re.findall(r"Used (\d+) registers", log)]
        rows[v][f"{kernel} spill bytes"] = max(
            [int(b) for b in re.findall(r"(\d+) bytes spill stores", log)]
            or [0])
    order = list(sources) + list(sources)[::-1]
    for name, (kernel, call) in cases(torch.device("cuda")).items():
        for v in order:
            wrappers[kernel].KERNEL.bound = libs[v, kernel]
            rows[v].setdefault(f"{name} ms", []).append(
                cs.cuda_ms(lambda: call(cb, cbs), 10))
    for row in rows.values():
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
