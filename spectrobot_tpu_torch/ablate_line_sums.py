"""Ablation builds of the line sums (K1, K3), the transpose (K5), the ring
exchange and the fused halo kernel on one CUDA GPU, and the audit of K1's
and K3's inner loops in SASS.

    python -m spectrobot_tpu_torch.ablate_line_sums [--parent DIR]
        [--kernels opacity_batch,basis_transpose,opacity_single,dma_ring,
                   dma_halo]
        [--parent-only]

Run from the repository root (it reads chip_smoke.py's cases).  Each
variant is built from a copy of spectrobot_tpu_torch/csrc with one part of a
kernel taken out by a text edit (the run fails if an edit no longer
applies):

  full        the kernels as they are;
  no_voigt    K1, K3 and the fused halo kernel without the Voigt
              arithmetic: a pair within the cutoff adds dnu * sx + y; the
              staging, the cutoff test and the loop remain;
  pts1        K1 with one grid point per thread (128 threads);
  pts2        K3 with two grid points per thread (64 threads);
  pts4        K1 and K3 with four grid points per thread (32 threads);
  no_skips    K1 and K3 walking every line of every sub-block (not its run
              of lines within reach of the tile), K5 without its whole-warp
              skip of tiles beyond the cutoff;
  no_sum      K3 without the sum of its segments (the last block of a tile
              resets its counter and returns);
  no_basis    K5 without the basis: a pair within the cutoff contributes
              (x, y, x y); the staging, the walk and the contraction
              remain;
  no_split    K5 with one segment per line block (no split of the tile
              walk);
  no_windows  the fused kernel walking every line block of every source,
              as its parent did (its segments cut on all of them);
  static_deal the fused kernel's items dealt to the blocks in turn (item
              b + m gridDim.x to block b), not taken from its work counter;
  free_registers  the fused kernel built without its least resident
              blocks an SM (ptxas then takes 72 registers, not 64);
  sys_scope   the ring on the loopback with the protocol at system scope
              (.sys, __threadfence_system) as between cards;
  two_pass    the ring on the loopback through the receive buffers (store
              into the neighbour's buffer, then copy it out chunk by
              chunk), the path of a ring of ranks;
  plain_launch  the ring launched as an ordinary kernel, not a cooperative
              one (the same grid; it measures the cooperative launch's
              host cost, and gives up its guarantee that every block is
              resident).

Of the parent's kernels (``--parent``): full, no_voigt, no_basis, and

  no_sum      K3 without the sum of its segments, the fused halo kernel
              without its second pass (sum_parts_kernel).

``--parent DIR`` adds the package under DIR/spectrobot_tpu_torch (``git
archive <commit> spectrobot_tpu_torch | tar -x -C DIR``) as the variants
``parent/<variant>``, with the edits of ``PARENT_EDITS`` (written for
984dc8c, the fused kernel before its redesign), and compares the parent's
full K1, K3 and fused kernel with the checkout's on every case (K1 and K3
bit for bit; the fused sums, whose segments moved, by the largest
difference against K1's budget) and its K5 by the largest difference.

Cases: chip_smoke.py's K1 inputs (the limb, nadir + chi, bench and bench +
chi cases; the limb's live states alone, which takes the dead-state blocks
out), K5 at R = 2 on the limb and the bench, at R = 66 on the limb, and at
B = 1 on the reference bench's dense shape (20480 lines x 16384 points, no
cutoff); K3 on chip_smoke.py's cases (the dense shape, the deepest bench
state, the deepest nadir state with chi and 4 rows) and on config 1's
inputs (3001 points); the ring on the loopback ring of this card: 4 shards
of [5, 8192] floats (chip_smoke.py's timed case) and 2 and 8 shards of
[64, 1000]; the fused halo kernel on the loopback ring: the dense shape
on 4 shards at a 10 cm-1 cutoff (chip_smoke.py's timed case), the deepest
bench state on 2 and 4 shards at 25 and on 8 at 10.  Times, each case over
the variants in turns, forward and then reverse order: the wrapper call
(CUDA events, median of 10 after a warm-up), the kernel alone
(``torch.profiler``'s device time per launch of the kernel, over 10 calls
of one launch each; for the parent's K3 and fused kernel also the sum
pass), for K3, the ring and the fused kernel the host clock per call over
20 calls back to back (until issued, until done), and for the fused
kernel its entry point (``dma_halo.fused_halo_accumulate_fn``: events and
host issue) and, once per case, the two tensor operations the parent's
entry point ran around the wrapper (``pack_lines`` and the loopback's
layout of the result).  Prints the card's name and power limit, the
fused kernel's ptxas report, the loops of K1's and K3's kernels in SASS
(``cuobjdump -sass``: for each loop, its instructions and their kinds),
then one JSON line per variant with its registers, static shared memory,
spills and times.  An ablated build computes wrong results by
construction: only ``full`` and ``parent/full`` are results, and each full
ring is held bit-equal to ``torch.roll``.
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

# kernel -> (module that loads its library, name of its loader).
KERNELS = {"opacity_batch": ("ops.cuda_opacity", "_library"),
           "basis_transpose": ("ops.cuda_transpose", "_library"),
           "opacity_single": ("ops.cuda_single", "_library"),
           "dma_ring": ("parallel.peer", "library"),
           "dma_halo": ("ops.cuda_dma", "_library")}
# The wrapper modules a parent set loads from its own sources, in import
# order (each later one imports the earlier ones).
PARENT_MODULES = ("ops.cuda_opacity", "ops.cuda_single",
                  "ops.cuda_transpose", "parallel.peer", "ops.cuda_dma",
                  "dma_halo")
SASS_KERNELS = ("opacity_batch", "opacity_single")

# variant -> [(kernel, file in csrc, old text, new text)].
NO_VOIGT = [(k, "voigt_primal.cuh",
             "  const float x = dnu * sx;\n  if (TIER == FAR) {",
             "  wr = fmaf(dnu, sx, y);\n  return true;\n"
             "  const float x = dnu * sx;\n  if (TIER == FAR) {")
            for k in ("opacity_batch", "opacity_single", "dma_halo")]
NO_BASIS = [(
    "basis_transpose", "voigt_basis.cuh",
    "  const float x = dnu * sx;\n  basis_pair<TIER>(x, y, K, kx, ky);",
    "  const float x = dnu * sx;\n  K = x;\n  kx = y;\n  ky = x * y;")]


# K3 without the sum of its segments (the last block of a tile resets its
# counter and returns).
K3_NO_SUM = ("opacity_single", "opacity_single.cu", "  if (!s_last) return;",
             "  if (threadIdx.x == 0 && s_last) counters[tile] = 0;\n"
             "  return;")


def _both(file: str, old: str, new: str) -> list:
    """An edit of the loop K1 and K3 share, for both kernels."""
    return [(k, file, old, new) for k in ("opacity_batch", "opacity_single")]


EDITS = {
    "full": [],
    "no_voigt": NO_VOIGT,
    "pts1": [("opacity_batch", "opacity_batch.cu", "constexpr int PTS = 2;",
              "constexpr int PTS = 1;")],
    "pts2": [("opacity_single", "opacity_single.cu",
              "constexpr int PTS = 1;", "constexpr int PTS = 2;")],
    "pts4": [("opacity_batch", "opacity_batch.cu", "constexpr int PTS = 2;",
              "constexpr int PTS = 4;"),
             ("opacity_single", "opacity_single.cu",
              "constexpr int PTS = 1;", "constexpr int PTS = 4;")],
    "no_skips": _both("line_sum_item.cuh",
                      "__ballot_sync(0xffffffffu, real && !beyond_reach(c, "
                      "c, t))", "__ballot_sync(0xffffffffu, true)")
                + [("basis_transpose", "basis_transpose.cu",
                    "if (gap > reach) continue;",
                    "if (gap > reach && false) continue;")],
    "no_sum": [K3_NO_SUM],
    "no_basis": NO_BASIS,
    "no_split": [("basis_transpose", "basis_transpose.cu",
                  "  const dim3 grid(n_lblk, B, n_seg * ((R + RR - 1) / RR));",
                  "  n_seg = 1;\n  seg_tiles = 1 << 30;\n"
                  "  const dim3 grid(n_lblk, B, n_seg * ((R + RR - 1) / RR));")],
    "no_windows": [("dma_halo", "dma_halo.cu",
                    "const Hull hull = reach_hull(rg, s.nb, t);",
                    "const Hull hull{0, s.nb, true};")],
    "static_deal": [("dma_halo", "dma_halo.cu",
                     "      const int taken = atomicAdd(queue, 1);\n"
                     "      if (taken == items - 1) *queue = 0;\n"
                     "      s_item = gridDim.x + taken;",
                     "      s_item = i + gridDim.x;")],
    "free_registers": [("dma_halo", "dma_halo.cu",
                        "__launch_bounds__(THREADS, MIN_BLOCKS)",
                        "__launch_bounds__(THREADS)")],
    "plain_launch": [("dma_ring", "dma_ring.cu",
                      "cudaLaunchCooperativeKernel(", "cudaLaunchKernel(")],
    "sys_scope": [("dma_ring", "dma_ring.cu",
                   "(void*)dma_ring_kernel<GPU_SCOPE, false, VEC>",
                   "(void*)dma_ring_kernel<SYS_SCOPE, false, VEC>")],
    "two_pass": [("dma_ring", "dma_ring.cu",
                  "(void*)dma_ring_kernel<GPU_SCOPE, false, VEC>",
                  "(void*)dma_ring_kernel<GPU_SCOPE, true, VEC>")],
}
# The ablations of the parent's kernels (984dc8c: the fused halo kernel
# before its redesign).
PARENT_EDITS = {
    "full": [],
    "no_voigt": NO_VOIGT,
    "no_basis": NO_BASIS,
    "no_sum": [K3_NO_SUM,
               ("dma_halo", "dma_halo.cu",
                "  sum_parts_kernel<<<(unsigned)((total + SUM_THREADS - 1) / "
                "SUM_THREADS),\n                     SUM_THREADS, 0, s>>>("
                "part, out, n_src * n_seg,\n"
                "                                          n_out * Pp, "
                "n_loc);",
                "  (void)total;")],
}
# Cases a variant is not timed on.
SKIP: dict = {}
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


def bind(mod, loader: str, path: str):
    """Load ``path`` as the library of module ``mod`` (the module's own
    binding code, its function ``loader``, sets the argument types)."""
    from spectrobot_tpu_torch.kernels import build

    load = build.load
    build.load = lambda name: ctypes.CDLL(path)
    try:
        mod._LIB = None
        return getattr(mod, loader)()
    finally:
        build.load = load


def checkout_modules() -> dict:
    import importlib
    return {rel: importlib.import_module(f"spectrobot_tpu_torch.{rel}")
            for rel in PARENT_MODULES}


def parent_modules(root: str) -> dict:
    """The parent's wrapper modules (``PARENT_MODULES`` under ``root``),
    loaded under their own names; while they load, each one stands in for
    the checkout's module of its name, so that they import one another.
    They take the checkout's window tables."""
    from spectrobot_tpu_torch.ops import cuda_opacity as co

    checkout_modules()
    mods, saved = {}, {}
    try:
        for rel in PARENT_MODULES:
            full = f"spectrobot_tpu_torch.{rel}"
            pkg_name, name = full.rsplit(".", 1)
            pkg = sys.modules[pkg_name]
            saved[full] = (sys.modules[full], getattr(pkg, name))
            path = os.path.join(root, "spectrobot_tpu_torch",
                                *rel.split(".")) + ".py"
            spec = importlib.util.spec_from_file_location(
                "parent_" + rel.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[full] = sys.modules[spec.name] = mod
            setattr(pkg, name, mod)
            spec.loader.exec_module(mod)
            mods[rel] = mod
    finally:
        for full, (mod, attr) in saved.items():
            sys.modules[full] = mod
            setattr(sys.modules[full.rsplit(".", 1)[0]],
                    full.rsplit(".", 1)[1], attr)
    mods["ops.cuda_opacity"].Windows = co.Windows
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


def config1_k3_inputs(dev) -> tuple:
    """K3's inputs in acceptance config 1's radiance (chip_smoke's scene
    and state, recorded from forward.model.nadir_single_layer): (nu,
    windows, nu_c, sx, y, amps, chi_b)."""
    import dataclasses

    import chip_smoke as cs
    from spectrobot_tpu_torch.forward.model import nadir_single_layer
    from spectrobot_tpu_torch.ops.cuda_basis import KERNELS as ENGINE

    seen = []

    def record(nu, windows, nu_c, sx, y, amps, **kw):
        seen.append((nu, windows, nu_c.contiguous(), sx.contiguous(),
                     y.contiguous(), amps.contiguous(), kw["chi_b"]))
        return torch.zeros(amps.shape[:1] + nu.shape, device=nu.device)

    _, dl, nu = cs.config1_scene(dev)
    x = [torch.tensor(v, dtype=torch.float32, device=dev)
         for v in cs.CONFIG1.values()]
    nadir_single_layer(nu, dl, *x, engine=dataclasses.replace(
        ENGINE, name="record", accumulate_single=record))
    (inputs,) = seen
    return inputs


def cases(dev, kernels) -> dict:
    """name -> (kernel, args, kwargs) of the wrapper call; for the ring,
    args are (shards, x [n, rows, cols])."""
    import chip_smoke as cs

    out = {}
    k1 = {c.name: c for c in cs.k1_cases(dev)}
    if "opacity_batch" in kernels:
        for name, c in k1.items():
            out[f"K1 {name}"] = ("opacity_batch", (
                c.nu, c.windows, c.nu_c, c.sx, c.y, c.amps),
                {"chi_b": c.chi_b})
        c = k1["limb"]
        live = torch.nonzero(c.amps.flatten(1).ne(0).any(1))[:, 0]
        sub = lambda a: a[live].contiguous()
        out["K1 limb, live states"] = ("opacity_batch", (
            c.nu, c.windows, sub(c.nu_c), sub(c.sx), sub(c.y), sub(c.amps)),
            {})
    if "basis_transpose" in kernels:
        dense = _dense_case(dev)
        for seed, (c, R) in enumerate(((k1["limb"], 2), (k1["limb"], 66),
                                       (k1["bench"], 2), (dense, 2))):
            ct = cs.cotangent_rows(c, R, 300 + seed)
            kw = {"chi_b": c.chi_b}
            if c.name == "dense":
                kw["cutoff_cm1"] = None
            out[f"K5 {c.name}, R = {R}"] = ("basis_transpose", (
                c.nu, c.windows, c.nu_c, c.sx, c.y, ct), kw)
    k3 = {c.name: c for c in cs.k3_cases(k1, dev)}
    if "opacity_single" in kernels:
        for c in k3.values():
            out[f"K3 {c.name}"] = ("opacity_single", (
                c.nu, c.windows, c.nu_c, c.sx, c.y, c.amps),
                {"chi_b": c.chi_b, "cutoff_cm1": c.windows.cutoff_cm1})
        nu, win, *rows, chi = config1_k3_inputs(dev)
        out["K3 config 1"] = ("opacity_single", (nu, win, *rows),
                              {"chi_b": chi, "cutoff_cm1": win.cutoff_cm1})
    if "dma_ring" in kernels:
        g = torch.Generator(device=dev).manual_seed(61)
        for n, shape in ((4, (5, 8192)), (2, (64, 1000)), (8, (64, 1000))):
            x = torch.randn((n,) + shape, generator=g, device=dev)
            out[f"ring n={n} {list(shape)}"] = ("dma_ring", (n, x), {})
    if "dma_halo" in kernels:
        nu0 = {"dense": cs.dense_centers(dev),
               "bench state": cs.bench_device_lines(dev).nu0}
        for name, n, cut in (("dense", 4, 10.0), ("bench state", 2, 25.0),
                             ("bench state", 4, 25.0),
                             ("bench state", 8, 10.0)):
            c = k3[name]
            skl = cs.halo_partition(c, nu0[name], n, cut)
            out[f"fused {name}, n={n}, cutoff {cut:g}"] = (
                "dma_halo", (n, c.nu, skl), {"cutoff_cm1": cut})
    return out


def ring_host_split(ring, x, n: int = 1000) -> dict:
    """Host clock per call [ms] of the ring wrapper on ``x`` and of its
    parts, each over ``n`` calls back to back after a warm-up: the tensor
    it allocates, the stream lookup (PyTorch's Stream object, and the raw
    handle the wrapper takes), a device context (which the wrapper does
    without), the launch of the last call's arguments alone, and, as the
    yardstick, torch.roll of the same blocks."""
    import time

    from spectrobot_tpu_torch.ops import cuda_dma
    from spectrobot_tpu_torch.parallel import peer

    dev = x.device
    lib = peer.library()

    def context():
        with torch.cuda.device(dev):
            pass

    parts = {
        "wrapper": lambda: cuda_dma.ring_exchange_cuda(ring, x, 1),
        "torch.roll": lambda: torch.roll(x, 1, 0),
        "empty_like": lambda: torch.empty_like(x),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "device context": context,
        "launch alone": lambda: lib.dma_ring_launch(ctypes.byref(
            ring.workspace.ring_args)),
    }
    out = {}
    for name, fn in parts.items():
        if name == "launch alone":   # relaunches write into a live output
            keep = cuda_dma.ring_exchange_cuda(ring, x, 1)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = 1e3 * (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
    del keep
    return out


def _ring_of(mods: dict, rings: dict, n: int, dev):
    if n not in rings:
        rings[n] = mods["parallel.peer"].loopback_ring(n, dev)
    return rings[n]


def fused_host_split(ring, a: tuple, kw: dict, n: int = 1000) -> dict:
    """Host clock per call [ms] of the checkout's fused entry point and
    wrapper on the case ``a`` and of their parts, each over ``n`` calls
    back to back after a warm-up: the two allocations, the workspace and
    counter lookups, and the launch of the last call's arguments alone."""
    import time

    from spectrobot_tpu_torch import dma_halo
    from spectrobot_tpu_torch.ops import cuda_dma
    from spectrobot_tpu_torch.ops.cuda_single import current_stream
    from spectrobot_tpu_torch.ops.opacity import KernelLines
    from spectrobot_tpu_torch.parallel.halo import pack_lines

    n_sh, nu, skl = a
    nu_k = nu.reshape(n_sh, -1)
    packed = pack_lines(KernelLines(*skl[:4])).contiguous()
    lib = cuda_dma._library()
    seen = []
    launch = lib.dma_halo_launch
    lib.dma_halo_launch = lambda *args: seen.append(args) or launch(*args)
    entry = dma_halo.fused_halo_accumulate_fn(ring, **kw)
    keep = entry(nu, skl)                 # the buffers the relaunch writes
    lib.dma_halo_launch = launch
    dev = nu.device
    parts = {
        "entry point": lambda: entry(nu, skl),
        "wrapper": lambda: cuda_dma.fused_halo_accumulate_cuda(
            ring, nu_k, packed, **kw),
        "torch.empty": lambda: torch.empty((2, 4096), device=dev),
        "workspace and epoch": lambda: (ring.workspace_for(1),
                                        ring.begin_call()),
        "stream and counters": lambda: cuda_dma.arrival_counters(
            cuda_dma._COUNTERS, dev, current_stream(dev.index), 1),
        "launch alone": lambda: launch(*seen[-1]),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = 1e3 * (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
    del keep
    return out


def wrapper_call(kernel: str, mods: dict, rings: dict, a: tuple, kw: dict):
    """The call of ``kernel``'s wrapper in the module set ``mods`` on the
    case's arguments (the ring's and the fused sum's on this set's
    loopback rings; the fused sum's lines packed outside the call)."""
    if kernel == "dma_halo":
        from spectrobot_tpu_torch.ops.opacity import KernelLines
        from spectrobot_tpu_torch.parallel.halo import pack_lines

        n, nu, skl = a
        packed = pack_lines(KernelLines(*skl[:4])).contiguous()
        fn = mods["ops.cuda_dma"].fused_halo_accumulate_cuda
        args = (_ring_of(mods, rings, n, nu.device), nu.reshape(n, -1),
                packed)
    elif kernel == "opacity_batch":
        fn, args = mods["ops.cuda_opacity"].accumulate_batch, a
    elif kernel == "basis_transpose":
        fn, args = mods["ops.cuda_transpose"].basis_transpose_batch, a
    elif kernel == "opacity_single":
        fn, args = mods["ops.cuda_single"].accumulate_single, a
    else:
        n, x = a
        fn, args = mods["ops.cuda_dma"].ring_exchange_cuda, (
            _ring_of(mods, rings, n, x.device), x, 1)
    return lambda: fn(*args, **kw)


def entry_call(mods: dict, rings: dict, a: tuple, kw: dict):
    """The fused sum's call through its entry point
    (``dma_halo.fused_halo_accumulate_fn`` of the set ``mods``: the lines
    packed, the wrapper, the shards' sums laid out as the grid's)."""
    n, nu, skl = a
    f = mods["dma_halo"].fused_halo_accumulate_fn(
        _ring_of(mods, rings, n, nu.device), **kw)
    return lambda: f(nu, skl)


def entry_parts(a: tuple, kw: dict) -> dict:
    """Device time [ms, CUDA events] of the two tensor operations around
    the fused wrapper in its entry point: the packing of the lines and
    the loopback's layout of the result."""
    from spectrobot_tpu_torch.ops.cuda_dma import fused_halo_accumulate_plain
    from spectrobot_tpu_torch.ops.opacity import KernelLines
    from spectrobot_tpu_torch.parallel.halo import pack_lines

    import chip_smoke as cs

    n, nu, skl = a
    lines = KernelLines(*skl[:4])
    out = torch.empty((n, skl.amps.shape[1], nu.shape[0] // n),
                      device=nu.device)
    return {"pack_lines ms": cs.cuda_ms(lambda: pack_lines(lines), REPEATS),
            "layout ms": cs.cuda_ms(lambda: out.transpose(0, 1).reshape(
                out.shape[1], -1), REPEATS)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--parent-only", action="store_true",
                    help="time the parent's variants alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_line_sums: no CUDA device", file=sys.stderr)
        return 1
    kernels = tuple(args.kernels.split(","))
    if not set(kernels) <= set(KERNELS):
        ap.error(f"--kernels takes {', '.join(KERNELS)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from spectrobot_tpu_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    sets = {} if args.parent_only else {
        "": (str(build.SOURCE_DIR), EDITS, checkout_modules())}
    if args.parent:
        sets["parent/"] = (os.path.join(args.parent, "spectrobot_tpu_torch",
                                        "csrc"), PARENT_EDITS,
                           parent_modules(args.parent))
    jobs = []
    for prefix, (src, edits, _) in sets.items():
        for v, e in edits.items():
            for kernel in kernels:
                if v == "full" or any(k == kernel for k, *_ in e):
                    jobs.append((prefix + v, src, e, kernel))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build_variant(*j[1:]), jobs))
    libs, rows = {}, {}
    for (v, _, _, kernel), (path, log) in zip(jobs, built):
        prefix = "parent/" if v.startswith("parent/") else ""
        libs[v, kernel] = (prefix, path)
        row = rows.setdefault(v, {"variant": v, "card": card})
        row[f"{kernel} registers"] = [
            int(r) for r in re.findall(r"Used (\d+) registers", log)]
        row[f"{kernel} smem bytes"] = [
            int(r) for r in re.findall(r"(\d+) bytes smem", log)]
        row[f"{kernel} spill bytes"] = max(
            [int(b) for b in re.findall(r"(\d+) bytes spill stores", log)]
            or [0])
        if kernel == "dma_halo":
            for line in log.splitlines():
                if "dma_halo_kernel" in line or "Used" in line:
                    print(f"ptxas {v}: {line.strip()}")
        if kernel in SASS_KERNELS and v.endswith("full"):
            for loop in sass_loops(path):
                print(f"sass {v}: {json.dumps(loop)}")
    bound = {}
    for (v, kernel), (prefix, path) in libs.items():
        rel, loader = KERNELS[kernel]
        bound[v, kernel] = bind(sets[prefix][2][rel], loader, path)
    rings = {prefix: {} for prefix in sets}
    all_cases = cases(torch.device("cuda"), kernels)
    for name, (kernel, a, kw) in all_cases.items():
        variants = [v for v, k in libs if k == kernel
                    and not any(s in name for s in SKIP.get(
                        v.split("/")[-1], ()))]
        outs = {}
        for v in variants + variants[::-1]:
            prefix = libs[v, kernel][0]
            mods = sets[prefix][2]
            rel, _ = KERNELS[kernel]
            mods[rel]._LIB = bound[v, kernel]
            call = wrapper_call(kernel, mods, rings[prefix], a, kw)
            row = rows[v]
            row.setdefault(f"{name} ms", []).append(cs.cuda_ms(call,
                                                               REPEATS))
            row.setdefault(f"{name} kernel ms", []).append(
                cs.kernel_ms(call, kernel, REPEATS))
            if kernel in ("opacity_single", "dma_halo") and prefix:
                row.setdefault(f"{name} sum pass ms", []).append(
                    cs.kernel_ms(call, "sum_parts", REPEATS))
            if kernel in ("dma_ring", "opacity_single", "dma_halo"):
                issue, total = cs.host_ms(call)
                row.setdefault(f"{name} host issue ms", []).append(issue)
                row.setdefault(f"{name} host total ms", []).append(total)
            if kernel == "dma_halo":
                entry = entry_call(mods, rings[prefix], a, kw)
                row.setdefault(f"{name} entry ms", []).append(
                    cs.cuda_ms(entry, REPEATS))
                row.setdefault(f"{name} entry host issue ms", []).append(
                    cs.host_ms(entry)[0])
            if v.endswith("full") and v not in outs:
                outs[v] = call()
        if kernel == "dma_halo":
            print(f"fused entry point's tensor operations, {name}: "
                  f"{json.dumps(entry_parts(a, kw))}")
            if "" in sets:
                print(f"fused host split, {name}: " + json.dumps(
                    fused_host_split(rings[""][a[0]], a, kw)))
        if kernel == "dma_ring" and "" in sets:
            print(f"ring host split, {name}: " + json.dumps(
                ring_host_split(rings[""][a[0]], a[1])))
        if kernel == "dma_ring":
            x = a[1]
            for v, got in outs.items():
                same = bool(torch.equal(got, torch.roll(x, 1, 0)))
                print(f"ring {v}, {name}: bit-equal to torch.roll {same}")
                if not same:
                    raise RuntimeError(f"{v}: the ring is not the roll")
        elif "parent/full" in outs and "full" in outs:
            got, ref = outs["full"], outs["parent/full"]
            if kernel in ("opacity_batch", "opacity_single", "dma_halo"):
                same = bool(torch.equal(got, ref))
                d = (got - ref).abs()
                m = float(ref.abs().max())
                budget = cs.RTOL * ref.abs() + cs.ATOL_REL * m
                print(f"{name} vs parent: bit-equal {same}; max |diff| "
                      f"{float(d.max()):.3e} of max {m:.3e}; "
                      f"{float((d / budget).max()):.3e} of K1's budget")
            else:
                d = max(float((g - r).abs().max()) for g, r in zip(got, ref))
                m = max(float(r.abs().max()) for r in ref)
                print(f"K5 vs parent, {name}: max |diff| {d:.3e} of max "
                      f"{m:.3e}")
        torch.cuda.empty_cache()
    for prefix, by_n in rings.items():
        for ring in by_n.values():
            ring.close()
    for row in rows.values():
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
