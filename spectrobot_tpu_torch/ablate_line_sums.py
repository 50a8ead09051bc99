"""Ablation builds of the line sum (K1) and its transpose (K5) on one CUDA
GPU, and the audit of K1's inner loops in SASS.

    python -m spectrobot_tpu_torch.ablate_line_sums [--parent DIR]

Run from the repository root (it reads chip_smoke.py's cases).  Each
variant is built from a copy of spectrobot_tpu_torch/csrc with one part of a
kernel taken out by a text edit (the run fails if an edit no longer
applies):

  full        the kernels as they are;
  no_voigt    K1 without the Voigt arithmetic: a pair within the cutoff
              adds dnu * sx + y; the staging, the cutoff test and the loop
              remain;
  pts1        K1 with one grid point per thread (128 threads a block);
  pts4        K1 with four grid points per thread (32 threads a block);
  no_skips    K1 walking every line of every sub-block (not its run of
              lines within reach of the tile), K5 without its whole-warp
              skip of tiles beyond the cutoff;
  no_basis    K5 without the basis: a pair within the cutoff contributes
              (x, y, x y); the staging, the walk and the contraction
              remain;
  no_split    K5 with one segment per line block (no split of the tile
              walk).

Of the parent's kernels (``--parent``): full, no_voigt, no_basis, and

  one_load    K1's inner loop reads only the line center per pair; the
              other staged values are read once per sub-block;
  one_warp    K5 with one warp per thread block, each block one 32-line
              sub-block, staging its own tiles (R = 2 cases only).

``--parent DIR`` adds the sources and wrappers under DIR/spectrobot_tpu_torch
(``git archive <commit> spectrobot_tpu_torch/csrc spectrobot_tpu_torch/ops
| tar -x -C DIR``) as the variants ``parent/<variant>``, with the edits of
``PARENT_EDITS``, and compares the parent's full K1 with the checkout's on
every case, bit for bit, and its K5 by the largest difference.

Cases: chip_smoke.py's K1 inputs (the limb, nadir + chi, bench and bench +
chi cases; the limb's live states alone, which takes the dead-state blocks
out), K5 at R = 2 on the limb and the bench, at R = 66 on the limb, and at
B = 1 on the reference bench's dense shape (20480 lines x 16384 points, no
cutoff).  Times, each case over the variants in turns, forward and then
reverse order: the wrapper call (CUDA events, median of 10 after a
warm-up) and the kernel alone (``torch.profiler``'s device time per
launch of the kernel, over 10 calls of one launch each).  Prints the
card's name and power limit, the loops of K1's kernels in SASS
(``cuobjdump -sass``: for each loop, its instructions and their kinds),
then one JSON line per variant with its registers, static shared memory,
spills and times.  An ablated build computes wrong results by
construction: only ``full`` and ``parent/full`` are results.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

KERNELS = {"opacity_batch": "cuda_opacity", "basis_transpose": "cuda_transpose"}

# variant -> [(kernel, file in csrc, old text, new text)].
NO_VOIGT = [(
    "opacity_batch", "voigt_primal.cuh",
    "  const float x = dnu * sx;\n  if (TIER == FAR) {",
    "  wr = fmaf(dnu, sx, y);\n  return true;\n"
    "  const float x = dnu * sx;\n  if (TIER == FAR) {")]
NO_BASIS = [(
    "basis_transpose", "voigt_basis.cuh",
    "  const float x = dnu * sx;\n  basis_pair<TIER>(x, y, K, kx, ky);",
    "  const float x = dnu * sx;\n  K = x;\n  kx = y;\n  ky = x * y;")]
EDITS = {
    "full": [],
    "no_voigt": NO_VOIGT,
    "pts1": [("opacity_batch", "opacity_batch.cu",
              "constexpr int PTS = 2;", "constexpr int PTS = 1;")],
    "pts4": [("opacity_batch", "opacity_batch.cu",
              "constexpr int PTS = 2;", "constexpr int PTS = 4;")],
    "no_skips": [("opacity_batch", "opacity_batch.cu",
                  "__ballot_sync(0xffffffffu, real && !(gap > reach))",
                  "__ballot_sync(0xffffffffu, true)"),
                 ("basis_transpose", "basis_transpose.cu",
                  "if (gap > reach) continue;",
                  "if (gap > reach && false) continue;")],
    "no_basis": NO_BASIS,
    "no_split": [("basis_transpose", "basis_transpose.cu",
                  "  const dim3 grid(n_lblk, B, n_seg * ((R + RR - 1) / RR));",
                  "  n_seg = 1;\n  seg_tiles = 1 << 30;\n"
                  "  const dim3 grid(n_lblk, B, n_seg * ((R + RR - 1) / RR));")],
}
# The same ablations on the sources of 8b6fafa (the kernels before their
# redesign).
PARENT_EDITS = {
    "full": [],
    "no_voigt": NO_VOIGT,
    "one_load": [(
        "opacity_batch", "opacity_batch.cu",
        "pair_wr<TIER, HAS_CHI>(nu_p - s.nuc[i], s.sx[i], s.y[i],\n"
        "                                HAS_CHI ? s.chi[i] : 0.0f, cutoff, wr))\n"
        "      continue;\n"
        "    acc0 = fmaf(s.a0[i], wr, acc0);\n"
        "    acc1 = fmaf(s.a1[i], wr, acc1);",
        "pair_wr<TIER, HAS_CHI>(nu_p - s.nuc[i], s.sx[base], s.y[base],\n"
        "                                HAS_CHI ? s.chi[base] : 0.0f, cutoff,"
        " wr))\n"
        "      continue;\n"
        "    acc0 = fmaf(s.a0[base], wr, acc0);\n"
        "    acc1 = fmaf(s.a1[base], wr, acc1);")],
    "no_basis": NO_BASIS,
    "one_warp": [
        ("basis_transpose", "basis_transpose.cu",
         "  const int blk = blockIdx.x;\n",
         "  const int blk = blockIdx.x / N_WARP;\n"),
        ("basis_transpose", "basis_transpose.cu",
         "  const size_t l = (size_t)blk * BLOCK_L + tid;",
         "  const size_t l = (size_t)blockIdx.x * 32 + tid;"),
        ("basis_transpose", "basis_transpose.cu",
         "    const float nu_p = nu[p0 + tid];\n"
         "    nu_s[tid] = nu_p;\n"
         "    for (int r = 0; r < R; ++r)\n"
         "      ct_s[r * TILE_P + tid] = ct_b[(size_t)r * Pp + p0 + tid];\n",
         "    float lo = INFINITY, hi = -INFINITY;\n"
         "    for (int q = tid; q < TILE_P; q += 32) {\n"
         "      const float v = nu[p0 + q];\n"
         "      nu_s[q] = v;\n"
         "      lo = fminf(lo, v);\n"
         "      hi = fmaxf(hi, v);\n"
         "      for (int r = 0; r < R; ++r)\n"
         "        ct_s[r * TILE_P + q] = ct_b[(size_t)r * Pp + p0 + q];\n"
         "    }\n"),
        ("basis_transpose", "basis_transpose.cu",
         "    const float lo = warp_min(nu_p), hi = warp_max(nu_p);\n"
         "    if (lane == 0) {\n"
         "      s_lo[warp] = lo;\n"
         "      s_hi[warp] = hi;\n"
         "    }\n"
         "    __syncthreads();\n"
         "    float tile_lo = s_lo[0], tile_hi = s_hi[0];\n"
         "#pragma unroll\n"
         "    for (int w = 1; w < N_WARP; ++w) {\n"
         "      tile_lo = fminf(tile_lo, s_lo[w]);\n"
         "      tile_hi = fmaxf(tile_hi, s_hi[w]);\n"
         "    }\n",
         "    __syncwarp();\n"
         "    const float tile_lo = warp_min(lo), tile_hi = warp_max(hi);\n"),
        ("basis_transpose", "basis_transpose.cu",
         "  const dim3 grid(Lp / BLOCK_L, B);\n"
         "  basis_transpose_kernel<HAS_CHI, REG><<<grid, BLOCK_L, smem, "
         "stream>>>(",
         "  const dim3 grid(Lp / 32, B);\n"
         "  basis_transpose_kernel<HAS_CHI, REG><<<grid, 32, smem, "
         "stream>>>(")],
}
# Cases a variant is not timed on (one_warp keeps K5's shared accumulators
# of 128 lines for its 32: above R = 2 it holds one warp per SM).
SKIP = {"one_warp": ("R = 66",)}
REPEATS = 10


def build_variant(src: str, edits: list, kernel: str) -> tuple:
    """Compile ``kernel`` from a copy of ``src`` with its ``edits``; returns
    (library path, ptxas report)."""
    from spectrobot_tpu_torch.kernels import build

    d = tempfile.mkdtemp(prefix=f"ablate_{kernel}_")
    for f in os.listdir(src):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(src, f), d)
    for k, name, old, new in edits:
        if k != kernel:
            continue
        path = os.path.join(d, name)
        text = open(path).read()
        if old not in text:
            raise RuntimeError(f"{src}: an edit of {name} no longer applies")
        open(path, "w").write(text.replace(old, new))
    lib = os.path.join(d, f"lib{kernel}.so")
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib,
                           os.path.join(d, f"{kernel}.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {kernel} from {src}:\n"
                           f"{proc.stderr[-3000:]}")
    return lib, proc.stdout + proc.stderr


def bind(mod, path: str):
    """Load ``path`` as the library of wrapper module ``mod`` (the module's
    own binding code sets the argument types)."""
    from spectrobot_tpu_torch.kernels import build

    load = build.load
    build.load = lambda name: ctypes.CDLL(path)
    try:
        mod._LIB = None
        return mod._library()
    finally:
        build.load = load


def parent_modules(root: str) -> dict:
    """The parent's wrapper modules (``ops/cuda_opacity.py``,
    ``ops/cuda_transpose.py`` under ``root``), loaded under their own
    names; they take the checkout's window tables."""
    from spectrobot_tpu_torch.ops import cuda_opacity as co

    mods = {}
    for kernel, name in KERNELS.items():
        path = os.path.join(root, "spectrobot_tpu_torch", "ops", f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        mod.Windows = co.Windows
        if hasattr(mod, "check_windows"):
            mod.check_windows = co.check_windows
        mods[kernel] = mod
    return mods


def sass_loops(lib: str) -> list:
    """The loops of each kernel in ``lib``'s SASS: for every backward
    branch, the instructions from its target to the branch, by kind
    (opcode without modifiers)."""
    from spectrobot_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = []
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split("\n", 1)[0].strip()
        ins = [(int(a, 16), op) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            fn)]
        for a, op in ins:
            if not op.startswith("BRA"):
                continue
            m = re.search(rf"/\*{a:04x}\*/[^\n]*BRA[^\n]*?0x([0-9a-f]+)", fn)
            if m is None or int(m.group(1), 16) >= a:
                continue
            lo = int(m.group(1), 16)
            body = [o.split(".")[0] for x, o in ins if lo <= x <= a]
            kinds = Counter(body)
            out.append({"kernel": name, "from": hex(lo), "to": hex(a),
                        "instructions": len(body),
                        "fp32": sum(kinds[k] for k in (
                            "FFMA", "FMUL", "FADD", "FMNMX", "FSETP",
                            "FSEL")),
                        "mufu": kinds["MUFU"], "lds": kinds["LDS"],
                        "branches": kinds["BRA"] + kinds["BSSY"]
                        + kinds["BSYNC"],
                        "kinds": dict(kinds.most_common(12))})
    return out


def _dense_case(dev):
    import chip_smoke as cs
    from spectrobot_tpu_torch.data.lines import random_lines
    from spectrobot_tpu_torch.ops import cuda_opacity as co
    from spectrobot_tpu_torch.ops.opacity import line_kernel_inputs
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist

    dl = device_lines_from_linelist(random_lines(20480, 600.0, 740.0, seed=0),
                                    [(2, 1)], dtype=torch.float32,
                                    device=dev, nu_ref=0.0)
    kl = line_kernel_inputs(dl, 220.0, 300.0, 100.0,
                            amp_weights=torch.ones(2, dl.n_lines, device=dev))
    nu = torch.as_tensor(np.linspace(640.0, 700.0, 16384),
                         dtype=torch.float32, device=dev)
    return cs.K1Case("dense", nu, co.line_windows(nu, dl.nu0,
                                                  cutoff_cm1=None),
                     *(a[None].contiguous() for a in kl[:3]),
                     kl[3][None].contiguous(), None)


def cases(dev) -> dict:
    """name -> (kernel, args, kwargs) of the wrapper call."""
    import chip_smoke as cs

    k1 = {c.name: c for c in cs.k1_cases(dev)}
    out = {}
    for name, c in k1.items():
        out[f"K1 {name}"] = ("opacity_batch", (
            c.nu, c.windows, c.nu_c, c.sx, c.y, c.amps), {"chi_b": c.chi_b})
    c = k1["limb"]
    live = torch.nonzero(c.amps.flatten(1).ne(0).any(1))[:, 0]
    sub = lambda a: a[live].contiguous()
    out["K1 limb, live states"] = ("opacity_batch", (
        c.nu, c.windows, sub(c.nu_c), sub(c.sx), sub(c.y), sub(c.amps)), {})
    dense = _dense_case(dev)
    for seed, (c, R) in enumerate(((k1["limb"], 2), (k1["limb"], 66),
                                   (k1["bench"], 2), (dense, 2))):
        ct = cs.cotangent_rows(c, R, 300 + seed)
        kw = {"chi_b": c.chi_b}
        if c.name == "dense":
            kw["cutoff_cm1"] = None
        out[f"K5 {c.name}, R = {R}"] = ("basis_transpose", (
            c.nu, c.windows, c.nu_c, c.sx, c.y, ct), kw)
    return out


def kernel_ms(call, kernel: str, n: int = REPEATS) -> float:
    """Mean device time of a launch of the kernel named ``kernel`` over
    ``n`` calls [ms] (per launch recorded: the profiler may miss one)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if kernel in e.key]
    return (sum(e.device_time_total for e in found) / 1e3
            / max(sum(e.count for e in found), 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_line_sums: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from spectrobot_tpu_torch.kernels import build
    from spectrobot_tpu_torch.ops import cuda_opacity, cuda_transpose

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    sets = {"": (str(build.SOURCE_DIR), EDITS,
                 {"opacity_batch": cuda_opacity,
                  "basis_transpose": cuda_transpose})}
    if args.parent:
        sets["parent/"] = (os.path.join(args.parent, "spectrobot_tpu_torch",
                                        "csrc"), PARENT_EDITS,
                           parent_modules(args.parent))
    jobs = []
    for prefix, (src, edits, _) in sets.items():
        for v, e in edits.items():
            for kernel in KERNELS:
                if v == "full" or any(k == kernel for k, *_ in e):
                    jobs.append((prefix + v, src, e, kernel))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build_variant(*j[1:]), jobs))
    libs, rows = {}, {}
    for (v, _, _, kernel), (path, log) in zip(jobs, built):
        prefix = "parent/" if v.startswith("parent/") else ""
        libs[v, kernel] = (sets[prefix][2][kernel], path)
        row = rows.setdefault(v, {"variant": v, "card": card})
        row[f"{kernel} registers"] = [
            int(r) for r in re.findall(r"Used (\d+) registers", log)]
        row[f"{kernel} smem bytes"] = [
            int(r) for r in re.findall(r"(\d+) bytes smem", log)]
        row[f"{kernel} spill bytes"] = max(
            [int(b) for b in re.findall(r"(\d+) bytes spill stores", log)]
            or [0])
        if kernel == "opacity_batch" and v.endswith("full"):
            for loop in sass_loops(path):
                print(f"sass {v}: {json.dumps(loop)}")
    bound = {key: bind(mod, path) for key, (mod, path) in libs.items()}
    all_cases = cases(torch.device("cuda"))
    for name, (kernel, a, kw) in all_cases.items():
        variants = [v for v, k in libs if k == kernel
                    and not any(s in name for s in SKIP.get(
                        v.split("/")[-1], ()))]
        outs = {}
        for v in variants + variants[::-1]:
            mod = libs[v, kernel][0]
            mod._LIB = bound[v, kernel]
            fn = getattr(mod, "accumulate_batch" if kernel == "opacity_batch"
                         else "basis_transpose_batch")
            call = lambda: fn(*a, **kw)
            rows[v].setdefault(f"{name} ms", []).append(
                cs.cuda_ms(call, REPEATS))
            rows[v].setdefault(f"{name} kernel ms", []).append(
                kernel_ms(call, kernel))
            if v.endswith("full") and v not in outs:
                outs[v] = call()
        if "parent/full" in outs:
            got, ref = outs["full"], outs["parent/full"]
            if kernel == "opacity_batch":
                same = bool(torch.equal(got, ref))
                print(f"K1 vs parent, {name}: bit-equal {same}; max |diff| "
                      f"{float((got - ref).abs().max()):.3e}")
            else:
                d = max(float((g - r).abs().max()) for g, r in zip(got, ref))
                m = max(float(r.abs().max()) for r in ref)
                print(f"K5 vs parent, {name}: max |diff| {d:.3e} of max "
                      f"{m:.3e}")
        torch.cuda.empty_cache()
    for row in rows.values():
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
