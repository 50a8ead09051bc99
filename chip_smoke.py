#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spectrobot_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:
  1. environment: a CUDA device, torch/CUDA versions, the card's name and
     power limit;
  2. build: the seven kernels, the FMA measurement kernel and the fused RT
     epilogue from spectrobot_tpu_torch/csrc (one nvcc each, started
     together), with their ptxas reports;
  3. K1 (the line sum) against its plain PyTorch version on the card, in
     float32: the forward's own limb and nadir inputs
     (examples/mars_limb.toml) and the reference bench's production scale
     (2048 random lines, 8192 points, 20 rays, 32 levels), with and without
     the chi wing factor; all four Voigt tiers must occur;
  4. K2 (the basis contraction) against its plain version at the same
     inputs with 66 random nonzero coefficient rows (33 Jacobian columns x 2
     depths), and at the bench's inputs with R = 10 and R = 223 (K2's
     largest); all four tiers must occur;
  4b. K5 (the transposed basis contraction) against its plain version at
     the same inputs with random cotangent rows: R = 2 (a gradient) on the
     limb, nadir + chi and bench cases, R = 66 (a folded jacrev) on the
     limb; all four tiers must occur; and the adjoint identity
     <ct, K2(C)> = sum_k <C_k, K5(ct)_k> on the limb case;
  4c. K3 (the single-state line sum) against its plain version: one live
     state of the bench scale (n_out = 2, cutoff 25), the reference bench's
     dense shape (20480 lines x 16384 points, no cutoff) and a nadir state
     with chi and 4 random amplitude rows; all four tiers must occur;
  4d. the fused RT epilogue (ops/cuda_epilogue.py, csrc/rt_epilogue.cu)
     at the benchmark cells' shapes (mars15_lte: 20 rays x 31 layers, 32
     columns, LTE; mars43_nlte_fov: 40 x 32, 33 columns, non-LTE; 8192
     points, float32, the tangents in K2's layout, tests/epilogue_cases.py):
     the primal and the tangent (one launch each) against the composed
     epilogue, its plain version (optics_from_tau + layer_path_radiance
     and their vmapped jvp); each timed alone by CUDA events (median of 5)
     beside its bytes bound and the composed one;
  5. main path, forward: the CLI forward of examples/mars_limb.toml through
     K1 (its launch count must rise) and the fused epilogue (a float64
     atmosphere over float32 depths: one fused launch a K1, no composed
     call), radiances checked, then the same scene through the plain
     version;
  6. main path, retrieve: the CLI temperature retrieval of the same scene
     (self-test observations) through K1, K2 and the fused epilogue; K2
     must launch once per Jacobian and the epilogue once a forward and
     twice a Jacobian, every call fused (these launches are the kernel
     line's), the fit converge with chi2 falling, and the Jacobian at the
     prior through the kernels (fused) agree with the plain engine's; then the CLI
     forward and retrieve again with lines.chi = "co2_mars" (the forward
     against the plain engine's, the fit converged);
  6b. main path, reverse mode: the gradient of the retrieval cost
     1/2 |(y - y_obs) / sigma|^2 at the prior through
     retrieval_problem(analytic_jvp='rev'): one K1 and one K5 launch, equal
     to J^T dL/dy from the K1/K2 Jacobian and to the plain engine's
     reverse gradient; then the adjoint tool (spectrobot_tpu_torch.adjoint)
     at its defaults;
  6c. the mesh at world size 1 (NCCL, in-process): the sharded forward
     (parallel.sharded through parallel.oe) in the psum and nu-halo tiers
     against the single-device forward, through K1; the halo accumulation
     (parallel.halo.halo_accumulate_pallas_fn) on the bench state through
     K3, against the plain sum; the mesh bodies replayed as CUDA graphs
     (parallel.graphed): the slice at a 10 cm-1 cutoff in both tiers and
     the K3 halo accumulation, each on two states in turn, every replay
     bit-equal to the eager body and one K1 (K3) launch a replay (the
     first replay's counts held to the kernels its profiler trace shows), the
     slice within MESH_RTOL of one device, the graph pool's size, and the
     graphed forward's walls and host issue beside the eager body's; the
     transport of a captured exchange (collectives.capture_exchange: the
     ring kernel over a ring whose epochs the card counts) on a loopback
     ring of 4 shards at the slice's message size, both directions in one
     launch, eagerly and in a graph replayed 3 times, bit-equal to the
     rolls, the count of calls read back after each; a line with the NCCL
     runtime, the route and the capture rings' settings as read back; the
     sharded normal equations (F, H, g) against those of the
     single-device Jacobian (jacfwd: the eager body), K2 once per call;
  6d. the single-state line sum (ops.opacity.make_accumulate_op at one
     state) through its entry points: acceptance config 1
     (forward.model.nadir_single_layer, float32, 3001 points) against the
     plain engine and the float64 oracle, one K3 launch; its jacfwd over
     its 5 scalars one K3 and one K4 launch (R = 10), against the plain
     Jacobian;
     the dense shape of bench.py:bench_kernel (20480 lines x 16384 points,
     no cutoff), jacfwd of cross_sections over (T, p, p_self): one K3 and
     one K4 (R = 6); K4 on the rows of both Jacobians, and at R = 66 on random rows of the dense shape (also
     against K2 at B = 1), the deepest bench state and the deepest nadir
     state with chi, against its plain version; all four tiers must occur;
     cross_sections_batch over the slice's 32 layers one K1 launch, its
     jacfwd one K1 and one K2 (R = 64); the gradient of a scalar of
     config 1's cross sections in mode 'rev' one K3 and one K5 launch,
     against the jacfwd row;
  6e. the remote-copy halo tier (spectrobot_tpu_torch.dma_halo) on the
     loopback ring of one card: ring_exchange for 2, 4 and 8 shards of
     64 x 1000 floats and 1, 2, 3, 4 and 8 shards of 7 x 143 (not a multiple
     of 4 or of a copy item) in both directions, and 50 calls back to back
     on 3 shards, bit-equal to the roll, ring_halo_lines of the dense case's
     partitioned lines bit-equal to the roll, fused_halo_accumulate_fn
     against its plain version within K1's budget (the deepest bench state
     at 1, 2 and 4 shards with cutoff 25 and at 8 with cutoff 10; the dense
     shape at 4 shards with cutoff 10; the bench state with one shard's
     row shuffled, on 8184 points with rows of the longest shard's length
     (P_loc and L not multiples of 128), and with 1 and 8 amplitude rows),
     every call twice in a row and bit-equal; one launch per call and one
     device kernel (torch.profiler); the blocks each case stages against a
     walk over every block (the window rule's host mirror); then the ring
     and the fused kernel timed against their plain versions (the ring
     against torch.roll, with both host issue times and the ring's device
     time; the fused kernel's entry point, wrapper, kernel alone and host
     issue at the dense case);
  6f. acceptance config 3 (non-LTE CO2 4.3 um limb, the demo nu3
     pumping) and the composed features, float32: the small scene of
     tests/test_nlte_config3.py through K1 against the float64 oracle
     (config 1's budget); at full width (examples/mars_limb.toml's geometry
     on 2280-2400 cm-1) K1, K2 and K5 against their plain versions on the
     scene's own differing rows, Jacobian rows and gradient cotangents; the
     CLI forward (one K1), the Jacobian (one K1, one K2) against the plain
     engine's, the CLI retrieve (converged, chi2 falling, one K2 per
     Jacobian), the reverse gradient (one K1, one K5) against J^T dL/dy;
     then the composed scene (plus the CIA continuum and a 3 km FOV over 40
     fine rays): the CLI forward and retrieve, the Jacobian (finite), and
     the (1, 1, 1) mesh forward in the nu-halo tier against one device,
     its replay bit-equal to its first call and launching what its trace
     shows, its graph pool's size;
  6g. the (P, T) table tier and the 2-D climatology, float32: the LTE
     table of examples/mars_limb.toml (21 x 25 lattice) and config 3's
     non-LTE tables, each built in one K1 launch and held at every node to
     K1's budget against the plain build; the CLI forward through each
     table (one K1 launch, the build) within the reference's LUT budget of
     the direct CLI forward, and again from compute.lut_path (no launch);
     the 33-column Jacobian through each table (no launch; the LTE one
     within 0.05 of max |J| of the direct K1 + K2 Jacobian; its peak
     memory beside the direct one's); the CLI retrieve through each table
     (one K1 launch, the build, none per LM iteration; converged); on the
     (1, 1, 1) mesh the table built over the process group bit-equal to
     the serial one (also through the CLI's compute.lut_build_mesh), the
     mesh table forward within 1e-5 of one device's
     and its sharded normal equations against the table Jacobian's; the
     mars_zonal climatology at 45 deg N through the CLI forward and
     retrieve, line by line (K1, K2) and through its table;
  6h. the Weideman evaluator (compute.variant = "weideman": plain PyTorch
     in float64 on the card; no kernel evaluates it): config 1
     (forward.model.nadir_single_layer, 3001 points) against the float64
     oracle within the reference's 5e-4; the CLI forward of
     examples/mars_limb.toml against phase 5's kernel radiances within the
     two approximants' gap; the Jacobian at the prior (its peak memory)
     against phase 6's; the CLI retrieve with retrieval.max_iter = 2 (chi2
     below the prior's); the reverse gradient against J^T dL/dy; no kernel
     launches in any of them; then run.save_optics on the humlicek4 CLI
     forward (one K1 launch, optics.npz with the reference's keys,
     transmittance = exp(-values), the line-of-sight depths against the
     plain engine's within K1's budget); utils.profiling.trace around one
     forward (the trace holds the annotate name and K1's kernel); each
     sub-phase's wall time beside the card's name and power limit;
  7. timings with CUDA events (median of 5 after a warm-up): each kernel
     against its plain version, the warm forward, one warm Jacobian, one
     warm reverse gradient, and the retrieval's wall time and
     per-iteration median; config 3's warm forward wall, Jacobian and LM
     iteration, and K1, K2, K5 on its inputs beside their bounds; K3 on its
     bench-state and dense cases; the warm
     (1, 1, 1) mesh forward against the warm single-device one; K4 on its
     cases and the config-1 Jacobian; each kernel's bound (the larger of its
     bytes over the memory rate and its flops over the FP32 rate, counted
     from this run's inputs; for K2 and K4 the largest of the basis flops
     over the FP32 rate, the contraction's three TF32 passes over the TF32
     rate and the bytes, with the bound of an FP32-core contraction beside
     it); K1's and K5's bounds also at the bench scale and K5's at R = 66,
     beside their times; each table build (CUDA events) with its K1
     call's share and the plain build's time, and the forward wall, the
     Jacobian (and its peak memory) and the LM iteration through each
     table beside the direct ones.
  6i. (run after phase 7, on phase 6c's process group) the measurement
     tools at the reference's TPU sizes: first the bench's limb-scan and
     fused scenes through the kernels against the plain engine on the
     same state (radiances within K1's budget, the Jacobians, K2 at R =
     64, within K2_REL of max|ref|); the six measurements of
     spectrobot_tpu_torch.bench (every value finite and positive; K1 once
     a forward, K1 and K2 once a Jacobian, K3 once a dense call; the (1,
     1, 1) mesh forward within MESH_RTOL of one device; the FMA ceiling at
     most FMA_SLACK x the data sheet's 67 TFLOP/s and the dense kernel at
     most FMA_SLACK x 100 % of it); the FMA measurement kernel
     (csrc/fma_peak.cu) bit-equal to its plain chain (fmaf emulated
     exactly) at depths 64 and 256 on the bench's 2^24 ones and on 2^24
     random values; jac_kernel_bench's line; scaling at n = 1 in both
     tiers with its 1-device overhead record; trace_summary of the fused
     Jacobian (K2's kernel among its families); run_demo (converged, mean
     |dT| below the 7 K start, its spectrum file and, where matplotlib is
     installed, its two figures written); each sub-phase's wall time
     beside the card.
  6j. (after 6i, on phase 6c's process group) the nu-halo forward on the
     (1, 1, 1) mesh: one K1 launch and no exchange (one nu shard), within
     MESH_RTOL of the single-device forward; the trace tool's analysis
     (spectrobot_tpu_torch.halo_overlap.measure) of its one-card trace:
     device events in every forward and 0 exchange launches.
  6k. (after 6h, before phase 7) K2 past its row limit: at R = 228 and 450
     on the slice's states against its plain version (K2_REL), one launch
     a row group (2 and 3), its time beside its bound; acceptance config 5
     (examples/multispecies_retrieval.toml, CO2 + CO limb, n_x = 50): the
     CLI forward (one K1), the Jacobian at the prior (one K1, one K2)
     against the plain engine's, the CLI retrieve with max_iter 2 (chi2
     below the prior's); config 5 at 38 levels retrieving both species
     (n_x = 114): the unchunked Jacobian (one K1, K2 in two row groups)
     against the plain engine's; then the Jacobian's memory guard: the
     counted bytes (cli.jacobian_bytes) of the slice, config 3, the
     composed scene and the float64 Weideman slice within GUARD_RATIO of
     the measured increase of their peak memory (peak - resident), each
     unchunked, or within FUSED_GUARD_RATIO where the Jacobian's epilogue
     was the fused kernel (cli.JAC_LIVE_TANGENTS counts the composed
     epilogue's temporaries), config 5's Jacobians too where fused; the
     route each took, read from forward.limb.EPILOGUE_COUNTS, must be the
     fused one on the kernels' engine and the composed one elsewhere; each
     sub-phase's wall time beside the card.
  6l. (after 6k, before phase 7, on phase 6c's process group) the engine
     rule's two other humlicek4 configurations: compute.dtype = "float64"
     through the float32 kernels (ops.cuda_basis.KERNELS casts the
     pipeline's inputs and results) on examples/mars_limb.toml: the CLI
     forward (one K1, float64 radiances), the Jacobian at the prior (one
     K1, one K2, two fused epilogue launches; its peak memory against
     cli.jacobian_bytes within FUSED_GUARD_RATIO), the CLI retrieve (one
     K2 a Jacobian, converged), the
     reverse gradient (one K1, one K5; within F64_GRAD_REL of J^T dL/dy),
     config 3's forward and Jacobian, config 1 (one K3; its Jacobian one
     K3 and one K4; the float64 oracle's float32 budget), the LTE table
     build (one K1) and the (1, 1, 1) mesh forward in both tiers (a
     replay bit-equal to its eager first call, within MESH_RTOL of one
     device), each float64 and within the float32 budgets (K1's,
     K2_REL) of the same engine over the plain versions in float32; the
     slice's distance from the pure float64 plain engine; then
     compute.use_pallas = false (ops.cuda_basis.PLAIN) in float32 and
     float64, the CLI forward and the Jacobian with no kernel launch,
     against the kernels' in float32; the engine each configuration
     takes; the float64 walls beside float32's.
With --profiler-misses ROUNDS, phase 6e also counts how often a profiler
window misses the fused-halo kernel, with and without the host wait of
its check (profiler_misses).
The card's name and power limit (as nvidia-smi prints them) and the kernel
table as JSON (the seven ports under "kernels", the FMA measurement kernel
apart under "measurement_kernels", the fused epilogue, which ports no TPU
kernel, under "port_kernels") are the two lines before the last; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np
import torch

from spectrobot_tpu_torch.kernels import launch
from spectrobot_tpu_torch.roofline import (
    HBM_BYTES_S, REGION_FLOPS, REGION_FLOPS_GRAD, REGIONS, basis_batch_bytes,
    basis_bound_ms, bound_ms, line_sum_inputs, region_counts)

REPO = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(REPO, "examples", "mars_limb.toml")
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "opacity_batch": ("spectrobot_tpu_torch/csrc/opacity_batch.cu",
                      "spectrobot_tpu/ops/pallas_opacity.py:451"),
    "basis_batch": ("spectrobot_tpu_torch/csrc/basis_batch.cu",
                    "spectrobot_tpu/ops/pallas_opacity.py:751"),
    "basis_transpose": ("spectrobot_tpu_torch/csrc/basis_transpose.cu",
                        "spectrobot_tpu/ops/pallas_opacity.py:1023"),
    "opacity_single": ("spectrobot_tpu_torch/csrc/opacity_single.cu",
                       "spectrobot_tpu/ops/pallas_opacity.py:287"),
    "basis_single": ("spectrobot_tpu_torch/csrc/basis_single.cu",
                     "spectrobot_tpu/ops/pallas_opacity.py:701"),
    "dma_ring": ("spectrobot_tpu_torch/csrc/dma_ring.cu",
                 "benchmarks/dma_halo.py:60"),
    "dma_halo": ("spectrobot_tpu_torch/csrc/dma_halo.cu",
                 "benchmarks/dma_halo.py:102"),
}
# Measurement kernels: no TPU kernel is ported (bench.bench_roofline's FMA
# ceiling).
MEASUREMENT_KERNELS = {
    "fma_peak": ("spectrobot_tpu_torch/csrc/fma_peak.cu", None)}
# The port's own kernels: no TPU kernel is ported (the JAX package leaves
# the RT epilogue to XLA's fusion).
PORT_KERNELS = {
    "rt_epilogue": ("spectrobot_tpu_torch/csrc/rt_epilogue.cu", None)}
# The fused epilogue against the composed epilogue (its plain version),
# max |diff| over max |composed|, float32: within the cells' fit_gap
# (1e-5) and mars15_lte's jac_gap (3e-5) limits.
EPILOGUE_REL = {"primal": 1e-5, "tangent": 3e-5}
# K1 vs plain budget (the reference's Pallas parity budget,
# tests/test_pallas_opacity.py:90): |err| <= RTOL |ref| + ATOL_REL max|ref|.
RTOL, ATOL_REL = 3e-5, 1e-6
# The (1, 1, 1) mesh against the single-device path: radiances within
# MESH_RTOL; the sharded normal equations within MESH_RTOL of max |H| and
# max |g| of those built from the single-device Jacobian.
MESH_RTOL = 1e-5
# K2 vs plain, and the kernel Jacobian vs the plain one: max |err| <=
# K2_REL max|ref| (the reference's basis-kernel and Jacobian parity,
# tests/test_pallas_jacobian.py:124,182).
K2_REL = 1e-5
K2_COLUMNS = 33            # Jacobian columns of the slice (R = 66 rows)
PLAIN_STATES = 64          # live states the plain version checks at scale
# The adjoint identity <ct, K2(C)> = sum_k <C_k, K5(ct)_k> holds to float32
# roundoff: |lhs - rhs| <= ADJ_REL x the larger sum of absolute products.
ADJ_REL = 1e-5
# The reverse gradient of the retrieval cost against J^T dL/dy and against
# the plain engine's: rtol, and atol as a share of max |g|.
GRAD_RTOL, GRAD_ATOL_REL = 2e-5, 1e-5
# Acceptance config 1 (tests/test_config1_golden.py: co2_15um_band(j_max=30),
# 3001 points over 630-705 cm-1): one layer over a blackbody surface.
CONFIG1 = dict(T_layer=215.0, p_layer_pa=500.0, column_m2=2.0e27,
               vmr_self=0.95, T_surface=260.0)
# Config 1's radiance against the float64 oracle (tests/golden/numpy_ref.py):
# the float32 hot-path budget of tests/test_config1_golden.py:57.
ORACLE_RTOL, ORACLE_ATOL_REL = 5e-3, 1e-4


# The labels this script prints for the kernels' launch counts, by
# __global__ name (``kernels.launch.KERNELS``; a kernel not named here goes
# by its own name).
LABELS = {"opacity_batch_kernel": "K1", "basis_batch_kernel": "K2",
          "basis_transpose_kernel": "K5", "opacity_single_kernel": "K3",
          "basis_single_kernel": "K4", "dma_ring_kernel": "dma_ring",
          "dma_halo_kernel": "dma_halo", "fma_chain_kernel": "fma_peak",
          "rt_epilogue_kernel": "epilogue"}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    launch.LAUNCHES.clear()


def launch_counts() -> dict:
    """Each kernel's launches since the last :func:`reset_launches`, by
    its label."""
    return {LABELS.get(k, k): launch.LAUNCHES[k]
            for k in launch.KERNELS.values()}


def expect_launches(what: str, n: dict, **want) -> None:
    """Fail unless the counts ``n`` are ``want`` (0 for a kernel not
    named; the fused epilogue, whose route the caller checks where it
    matters (:func:`epilogue_routes`), only where named)."""
    if "epilogue" not in want:
        n = {k: v for k, v in n.items() if k != "epilogue"}
    want = {k: want.get(k, 0) for k in n}
    check(n == want, f"{what} launched {json.dumps(n)}, not "
                     f"{json.dumps(want)}")


class K1Case(NamedTuple):
    name: str
    nu: torch.Tensor        # [P] offset grid
    windows: object         # the scene's window table (cuda_opacity.Windows)
    nu_c: torch.Tensor      # [B, L]
    sx: torch.Tensor
    y: torch.Tensor
    amps: torch.Tensor      # [B, 2, L]
    chi_b: Optional[torch.Tensor]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke failed: {what}")


def _chi(nu_c, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0.0, 0.3, tuple(nu_c.shape)),
                           dtype=torch.float32, device=nu_c.device)


def bench_device_lines(device, n_lines: int = 2048):
    """The reference bench's random line list (bench.py:
    bench_fused_pallas: 600-750 cm-1, seed 3), float32 on ``device``."""
    from spectrobot_tpu_torch.data.lines import random_lines
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist
    return device_lines_from_linelist(
        random_lines(n_lines, 600.0, 750.0, seed=3), [(2, 1)],
        dtype=torch.float32, device=device)


def k1_cases(device, *, n_points=None, bench_lines=2048, bench_points=8192,
             bench_rays=20):
    """The kernel inputs of phases 3 and 4, as the port's forward gives them
    to K1 (smaller sizes for a CPU rehearsal)."""
    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch.data.atmosphere import (
        MARS, mars_standard_atmosphere)
    from spectrobot_tpu_torch.retrieval.state import build_forward, make_state

    grid = {} if n_points is None else {"grid.n_points": str(n_points)}
    for mode, extra in (("limb", {}),
                        ("nadir", {"geometry.mode": "nadir",
                                   "geometry.sec_theta": "1.0,1.5,2.0"})):
        cfg = cli.load_config(SCENE, {**grid, **extra})
        scene = cli.build_scene(cfg, device)
        base = line_sum_inputs(lambda e: cli.run_forward(cfg, scene, e))
        if mode == "limb":
            yield K1Case("limb", *base, None)
        yield K1Case(f"{mode}+chi", *base, _chi(base[2], 7))

    # The reference bench's production scale (bench.py:bench_fused_pallas).
    dl = bench_device_lines(device, bench_lines)
    atm = mars_standard_atmosphere(n_lev=32, z_top=80e3, device=device)
    nu64 = np.linspace(600.0, 750.0, bench_points)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    fwd = lambda e: build_forward(
        atm, dl, f32(nu64), ["CO2"], MARS,
        tangent_heights_m=f32(np.linspace(5e3, 70e3, bench_rays)), n_sub=4,
        nu_off=f32(nu64 - float(dl.nu_ref)), engine=e)
    base = line_sum_inputs(
        lambda e: fwd(e)(make_state(atm, [], retrieve_temperature=False)))
    yield K1Case("bench", *base, None)
    yield K1Case("bench+chi", *base, _chi(base[2], 8))


def coefficient_rows(case: K1Case, n_t: int, seed: int):
    """K2's rows for ``n_t`` random tangents of the case's line states (the
    line sum's tangent coefficients, ops.opacity.basis_coefficients, folded
    as its vmap rule folds them: [B, 2 n_t, L]).  Every row is nonzero,
    also C2 (the Kx row), which a temperature-only Jacobian leaves 0."""
    from spectrobot_tpu_torch.ops.opacity import basis_coefficients

    g = torch.Generator(device=case.nu_c.device).manual_seed(seed)
    B, L = case.nu_c.shape
    rnd = lambda *shape: torch.randn((n_t,) + shape, generator=g,
                                     device=case.nu_c.device)
    C = basis_coefficients(case.sx, case.amps, rnd(B, L) * 1e-3,
                           rnd(B, L) * case.sx * 1e-2,
                           rnd(B, L) * case.y * 1e-2,
                           rnd(B, 2, L) * case.amps * 1e-2)
    return [c.transpose(0, 1).reshape(B, 2 * n_t, L).contiguous()
            for c in C]


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


def _sub(a, idx):
    return None if a is None else a[idx].contiguous()


def compare_k1(case: K1Case) -> dict:
    from spectrobot_tpu_torch.ops.cuda_opacity import (
        accumulate_batch, accumulate_batch_plain)

    got = accumulate_batch(case.nu, case.windows, case.nu_c, case.sx,
                           case.y, case.amps, chi_b=case.chi_b)
    torch.cuda.synchronize()
    idx = _states_checked(case)
    ref = accumulate_batch_plain(case.nu, _sub(case.nu_c, idx),
                                 _sub(case.sx, idx), _sub(case.y, idx),
                                 _sub(case.amps, idx),
                                 chi_b=_sub(case.chi_b, idx))
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


def compare_k2(case: K1Case, C) -> dict:
    from spectrobot_tpu_torch.ops.cuda_basis import (
        basis_contract_batch, basis_contract_batch_plain)

    got = basis_contract_batch(case.nu, case.windows, case.nu_c, case.sx,
                               case.y, *C, chi_b=case.chi_b)
    torch.cuda.synchronize()
    idx = _states_checked(case)
    ref = basis_contract_batch_plain(
        case.nu, _sub(case.nu_c, idx), _sub(case.sx, idx), _sub(case.y, idx),
        *(_sub(c, idx) for c in C), chi_b=_sub(case.chi_b, idx))
    got = got[idx]
    check(bool(torch.isfinite(got).all()), f"{case.name}: non-finite K2")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    row = {"case": case.name, "states": int(case.nu_c.shape[0]),
           "checked": int(idx.numel()), "lines": int(case.nu_c.shape[1]),
           "points": int(case.nu.shape[0]), "rows": int(C[0].shape[1]),
           "max_abs_err": err, "max_ref": scale,
           "budget": f"{K2_REL:g}*max|ref|",
           "err_over_budget": err / (K2_REL * scale)}
    print(f"K2 vs plain: {json.dumps(row)}")
    check(err <= K2_REL * scale, f"{case.name}: K2 disagrees with the plain "
                                 f"version ({err:.3g} of max {scale:.3g})")
    return row


def cotangent_rows(case: K1Case, R: int, seed: int) -> torch.Tensor:
    """Random cotangent rows [B, R, P] for K5 on the case's device: every
    state live, also those whose amplitudes are zero (their amplitude
    cotangent is not zero)."""
    g = torch.Generator(device=case.nu.device).manual_seed(seed)
    return torch.randn((case.nu_c.shape[0], R, case.nu.shape[0]),
                       generator=g, device=case.nu.device)


def compare_k5(case: K1Case, ct: torch.Tensor) -> dict:
    from spectrobot_tpu_torch.ops.cuda_transpose import (
        basis_transpose_batch, basis_transpose_batch_plain, segments)

    got = basis_transpose_batch(case.nu, case.windows, case.nu_c, case.sx,
                                case.y, ct, chi_b=case.chi_b)
    torch.cuda.synchronize()
    idx = _states_checked(case)
    ref = basis_transpose_batch_plain(
        case.nu, _sub(case.nu_c, idx), _sub(case.sx, idx), _sub(case.y, idx),
        ct[idx].contiguous(), chi_b=_sub(case.chi_b, idx))
    errs, scales = [], []
    for g, r in zip(got, ref):
        g = g[idx]
        check(bool(torch.isfinite(g).all()), f"{case.name}: non-finite K5")
        errs.append(float((g - r).abs().max()))
        scales.append(float(r.abs().max()))
    row = {"case": case.name, "states": int(case.nu_c.shape[0]),
           "checked": int(idx.numel()), "lines": int(case.nu_c.shape[1]),
           "points": int(case.nu.shape[0]), "rows": int(ct.shape[1]),
           "segments": segments(case.windows, case.nu_c.shape[0],
                                ct.shape[1]),
           "max_abs_err": max(errs),
           "outputs": {k: {"max_abs_err": e, "max_ref": m}
                       for k, e, m in zip(("K", "Kx", "xKx", "Ky"), errs,
                                          scales)},
           "budget": f"{K2_REL:g}*max|ref| per output",
           "err_over_budget": max(e / (K2_REL * m)
                                  for e, m in zip(errs, scales))}
    print(f"K5 vs plain: {json.dumps(row)}")
    check(row["err_over_budget"] <= 1.0,
          f"{case.name} (R = {ct.shape[1]}): K5 disagrees with the plain "
          f"version ({row['err_over_budget']:.3g} x the budget)")
    return row


def adjoint_identity(case: K1Case, C, ct: torch.Tensor) -> float:
    """<ct, K2(C)> against sum_k <C_k, K5(ct)_k> through the kernels, in
    float64 from their float32 outputs.  Returns |lhs - rhs| over the
    bound."""
    from spectrobot_tpu_torch.ops.cuda_basis import basis_contract_batch
    from spectrobot_tpu_torch.ops.cuda_transpose import basis_transpose_batch

    out = basis_contract_batch(case.nu, case.windows, case.nu_c, case.sx,
                               case.y, *C, chi_b=case.chi_b).double()
    Ab = basis_transpose_batch(case.nu, case.windows, case.nu_c, case.sx,
                               case.y, ct, chi_b=case.chi_b)
    ct = ct.double()
    lhs = float(torch.sum(ct * out))
    terms = [c.double() * a.double() for c, a in zip(C, Ab)]
    rhs = sum(float(torch.sum(t)) for t in terms)
    scale = max(float(torch.sum((ct * out).abs())),
                sum(float(torch.sum(t.abs())) for t in terms))
    ratio = abs(lhs - rhs) / (ADJ_REL * scale)
    print(f"adjoint identity ({case.name}, R = {ct.shape[1]}): <ct, K2(C)> "
          f"{lhs:.9e}, sum_k <C_k, K5(ct)_k> {rhs:.9e}, |diff| "
          f"{abs(lhs - rhs):.3e}; bound {ADJ_REL:g} x {scale:.6e} (the "
          f"larger sum of absolute products); diff / bound {ratio:.3e}")
    check(ratio <= 1.0, "K5 is not the adjoint of K2")
    return ratio


class K3Case(NamedTuple):
    name: str
    nu: torch.Tensor        # [P] grid
    windows: object         # cuda_opacity.Windows of the grid and lines
    nu_c: torch.Tensor      # [L]
    sx: torch.Tensor
    y: torch.Tensor
    amps: torch.Tensor      # [n_out, L]
    chi_b: Optional[torch.Tensor]

    def as_batch(self) -> K1Case:
        """The case as one state of a K1Case (for the tier and region
        counts)."""
        return K1Case(self.name, self.nu, self.windows, self.nu_c[None],
                      self.sx[None], self.y[None], self.amps[None],
                      None if self.chi_b is None else self.chi_b[None])


def _deepest_state(case: K1Case) -> int:
    """The live state of a case with the largest median y (the highest
    pressure): the one that reaches the near tiers."""
    live = torch.nonzero(case.amps.flatten(1).ne(0).any(1))[:, 0]
    return int(live[torch.argmax(case.y[live].median(dim=1).values)])


def k3_cases(cases: dict, device, *, dense_lines=20480,
             dense_points=16384):
    """K3's cases: the deepest live state of the bench scale (n_out = 2,
    the scene's windows), the reference bench's dense shape
    (bench.py:bench_kernel: random lines over 600-740 cm-1, seed 0, T = 220
    K, p = 300 Pa, every line at every point) and the deepest nadir state
    with chi and 4 random amplitude rows."""
    from spectrobot_tpu_torch.data.lines import random_lines
    from spectrobot_tpu_torch.ops import cuda_opacity as co
    from spectrobot_tpu_torch.ops.opacity import line_kernel_inputs
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist

    c = cases["bench"]
    b = _deepest_state(c)
    yield K3Case("bench state", c.nu, c.windows, c.nu_c[b], c.sx[b], c.y[b],
                 c.amps[b], None)
    dl = device_lines_from_linelist(random_lines(dense_lines, 600.0, 740.0,
                                                 seed=0), [(2, 1)],
                                    dtype=torch.float32, device=device,
                                    nu_ref=0.0)
    kl = line_kernel_inputs(dl, 220.0, 300.0, 100.0, amp_weights=torch.ones(
        2, dl.n_lines, device=device))
    nu = torch.as_tensor(np.linspace(640.0, 700.0, dense_points),
                         dtype=torch.float32, device=device)
    yield K3Case("dense", nu, co.line_windows(nu, dl.nu0, cutoff_cm1=None),
                 *(a.contiguous() for a in kl[:4]), None)
    c = cases["nadir+chi"]
    b = _deepest_state(c)
    rng = np.random.default_rng(4)
    rows = torch.as_tensor(rng.uniform(0.5, 1.5, (4, c.nu_c.shape[1])),
                           dtype=torch.float32, device=device)
    yield K3Case("nadir state, 4 rows", c.nu, c.windows, c.nu_c[b], c.sx[b],
                 c.y[b], (rows * c.amps[b, :1]).contiguous(), c.chi_b[b])


def compare_k3(case: K3Case) -> dict:
    from spectrobot_tpu_torch.ops.cuda_single import (
        accumulate_single, accumulate_single_plain, segments)

    got = accumulate_single(case.nu, case.windows, case.nu_c, case.sx,
                            case.y, case.amps, chi_b=case.chi_b,
                            cutoff_cm1=case.windows.cutoff_cm1)
    torch.cuda.synchronize()
    ref = accumulate_single_plain(case.nu, case.nu_c, case.sx, case.y,
                                  case.amps, chi_b=case.chi_b,
                                  cutoff_cm1=case.windows.cutoff_cm1)
    check(bool(torch.isfinite(got).all()), f"{case.name}: non-finite K3")
    err = (got - ref).abs()
    bound = RTOL * ref.abs() + ATOL_REL * ref.abs().max()
    worst = float((err / bound).max())
    row = {"case": case.name, "lines": int(case.nu_c.shape[0]),
           "points": int(case.nu.shape[0]), "rows": int(case.amps.shape[0]),
           "cutoff": case.windows.cutoff_cm1, "chi": case.chi_b is not None,
           "segments": segments(case.windows),
           "max_abs_err": float(err.max()), "max_ref": float(ref.abs().max()),
           "budget": f"{RTOL:g}*|ref| + {ATOL_REL:g}*max|ref|",
           "err_over_budget": worst}
    print(f"K3 vs plain: {json.dumps(row)}")
    check(worst <= 1.0, f"{case.name}: K3 disagrees with the plain version "
                        f"({worst:.3g} x the budget)")
    return row


def mesh_phase(cfg, scene, prob, x0, J, y_obs, sigma, bench: K3Case,
               bench_nu0: torch.Tensor, card: str) -> dict:
    """Phase 6c: the mesh at world size 1 on the card (NCCL, in-process).
    ``bench_nu0``: the unshifted centers of the bench state's lines.
    Returns K3's launch count and what phase 7 times; the process group
    stays up for phase 7, whose caller ends it."""
    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch.ops import cuda_single as cs
    from spectrobot_tpu_torch.ops.opacity import KernelLines
    from spectrobot_tpu_torch.parallel import halo
    from spectrobot_tpu_torch.parallel.mesh import (
        initialize_multihost, make_mesh)
    from spectrobot_tpu_torch.retrieval.state import flatten_state, make_state

    reset, counts = reset_launches, launch_counts
    made = initialize_multihost("cuda")
    check(made, "a process group existed before the mesh phase")
    out = {}
    mesh = make_mesh((1, 1, 1), "cuda")
    print(f"mesh: {mesh.shape} over {torch.distributed.get_world_size()}"
          f" rank ({torch.distributed.get_backend()}) on {mesh.device}")
    empty = make_state(scene.atm, [], retrieve_temperature=False)
    x_empty = flatten_state(empty)[0]
    I_single = cli.run_forward(cfg, scene).cpu().numpy()
    for tier, halo_on in (("psum", False), ("nu-halo", True)):
        cfg_t = dataclasses.replace(cfg, compute=dataclasses.replace(
            cfg.compute, mesh_halo=halo_on))
        oe = cli.sharded_problem(cfg_t, scene, mesh, scene.atm, empty)
        reset()
        I = oe.forward_flat(x_empty).reshape(I_single.shape)
        torch.cuda.synchronize()
        n = counts()
        I = I.cpu().numpy()
        err = float(np.abs(I - I_single).max())
        print(f"mesh forward ({tier} tier) vs single-device: max |err| "
              f"{err:.3e} of max {float(np.abs(I_single).max()):.3e}; "
              f"launches {json.dumps(n)}")
        check(n["K1"] == 1, f"the {tier} mesh forward launched K1 "
                            f"{n['K1']} times, not once")
        np.testing.assert_allclose(I, I_single, rtol=MESH_RTOL,
                                   atol=MESH_RTOL * np.abs(I_single).max())
        out[f"fwd_{tier}"] = oe

    # The halo accumulation through K3 on the bench state, partitioned
    # and windowed by the unshifted centers, as the scene's lines are.
    cut = bench.windows.cutoff_cm1
    nu_host = bench.nu.cpu().double().numpy()
    edges = halo.nu_shard_edges(nu_host, 1, cut)
    kl = KernelLines(bench.nu_c, bench.sx, bench.y, bench.amps)
    skl = halo.partition_kernel_lines(kl, bench_nu0, edges)
    f = halo.halo_accumulate_pallas_fn(
        mesh, nu_host, halo.partition_kernel_lines(
            kl._replace(nu_c=bench_nu0), bench_nu0, edges).nu_c,
        cutoff_cm1=cut)
    reset()
    got = f(bench.nu, halo.shard_lines(skl, 0))
    torch.cuda.synchronize()
    n = counts()
    ref = cs.accumulate_single_plain(bench.nu, bench.nu_c, bench.sx,
                                     bench.y, bench.amps, cutoff_cm1=cut)
    err = (got - ref).abs()
    worst = float((err / (RTOL * ref.abs() + ATOL_REL * ref.abs().max()))
                  .max())
    print(f"halo accumulation (K3) vs the plain sum: max |err| "
          f"{float(err.max()):.3e}, {worst:.3e} x K1's budget; launches "
          f"{json.dumps(n)}")
    check(n["K3"] == 1, f"the halo accumulation launched K3 {n['K3']} "
                        f"times, not once")
    check(worst <= 1.0, "the halo accumulation disagrees with the plain "
                        "sum")
    out["k3_launches"] = n["K3"]
    out["halo"] = (f, bench.nu, halo.shard_lines(skl, 0))
    graph_phase(mesh, f, out["halo"][1:], card)

    # The sharded normal equations against the single-device Jacobian.
    oe = cli.sharded_problem(cfg, scene, mesh, prob.atm,
                             prob.init(prob.atm))
    oe.bind_observation(y_obs.cpu().numpy(), sigma.cpu().numpy())
    reset()
    F, H, g = oe.normal_eqs(x0)
    torch.cuda.synchronize()
    n = counts()
    J64 = J.double().cpu().numpy()
    w = 1.0 / sigma.double().cpu().numpy() ** 2
    y0 = prob.fwd_flat(x0).double().cpu().numpy()
    H_ref = (J64.T * w) @ J64
    g_ref = (J64.T * w) @ (y_obs.double().cpu().numpy() - y0)
    errs = {"F": float(np.abs(F.double().cpu().numpy() - y0).max()
                       / np.abs(y0).max()),
            "H": float(np.abs(H.cpu().numpy() - H_ref).max()
                       / np.abs(H_ref).max()),
            "g": float(np.abs(g.cpu().numpy() - g_ref).max()
                       / np.abs(g_ref).max())}
    print(f"sharded normal equations vs the single-device Jacobian: "
          f"max |err| / max |ref| {json.dumps(errs)}; launches "
          f"{json.dumps(n)}")
    check(n["K2"] == 1, f"the sharded normal equations launched K2 "
                        f"{n['K2']} times, not once")
    check(all(v <= MESH_RTOL for v in errs.values()),
          "the sharded normal equations disagree with the single-device "
          "Jacobian's")
    out["x_empty"] = x_empty
    out["mesh"] = mesh
    return out


def graph_phase(mesh, halo_fn, halo_in: tuple, card: str) -> None:
    """Phase 6c, the mesh bodies replayed as CUDA graphs (parallel.graphed)
    on the (1, 1, 1) mesh: the slice (halo_overlap's scene, cutoff 10
    cm-1) in both tiers on two PathCG states, each replay bit-equal to the
    eager body on the same inputs and one K1 launch a replay, a state
    within MESH_RTOL of one device; the graphed forward's walls beside
    the eager body's; the K3 halo accumulation ``halo_fn`` replayed on its
    inputs ``halo_in`` and on other amplitudes, bit-equal to its eager
    body, one K3 launch a replay.  A replay's counts are also held to the
    kernels its profiler trace shows."""
    from spectrobot_tpu_torch import halo_overlap as ho
    from spectrobot_tpu_torch.parallel import graphed
    from spectrobot_tpu_torch.parallel import sharded as sh

    dev = mesh.device
    sc = ho.make_scene("slice", dev, 1)
    ref = ho.single_device_block(mesh, sc)
    nu_off = sc.nu_host - float(sc.lines.nu_ref)
    t = lambda a: torch.as_tensor(a, dtype=sc.cg.u.dtype, device=dev)
    # Two states: the scene's rays, and the same rays 2 % warmer with 10 %
    # less column.
    cgs = (sc.cg, sc.cg._replace(T_sp=sc.cg.T_sp * 1.02,
                                 T_air=sc.cg.T_air * 1.02, u=sc.cg.u * 0.9))

    def replays(name, f, calls, kernel):
        """The first call (eager, then the capture) and four replays of
        ``calls`` in turn (B, A, B, A), each against ``f.body``."""
        reset_launches()
        first = calls[0](f)
        torch.cuda.synchronize()
        n = launch_counts()
        expect_launches(f"{name}, first call (eager, then captured)", n,
                        **{kernel: 1})
        check(len(f.graphs) == 1, f"{name} captured {len(f.graphs)} graphs")
        check(torch.equal(first, calls[0](f.body)),
              f"{name}: the first call differs from the eager body")
        out = {}
        for j, i in enumerate((1, 0, 1, 0)):
            reset_launches()
            if j == 0:
                # The first replay traced: its kernels as the device ran
                # them, against the counts the replay added.
                traced, got = ho.traced_launches(lambda: calls[i](f), dev)
                check(traced == launch.LAUNCHES,
                      f"{name}: a replay's trace launched "
                      f"{json.dumps(traced)}, its counts say "
                      f"{json.dumps(launch.LAUNCHES)}")
            else:
                got = calls[i](f)
            torch.cuda.synchronize()
            n = launch_counts()
            expect_launches(f"{name}, a replay", n, **{kernel: 1})
            eager = calls[i](f.body)
            diff = float((got - eager).abs().max())
            check(torch.equal(got, eager),
                  f"{name}: replay on state {'AB'[i]} differs from the "
                  f"eager body by {diff:.3e}")
            out[i] = got
        check(f.replays == 4, f"{name} replayed {f.replays} times, not 4")
        check(not torch.equal(out[0], out[1]),
              f"{name}: the two states gave the same output")
        pool = sum(g.pool_bytes for g in f.graphs.values())
        print(f"6c graph: {name}: 4 replays on alternating states bit-equal "
              f"to the eager body; {kernel} once a replay, in the counts and "
              f"in a replay's trace; graph pool "
              f"{pool / 1e6:.2f} MB")
        return out

    for tier, halo in (("psum", False), ("nu-halo", True)):
        lines = (sh.partition_lines_by_nu(sc.lines, sc.nu_host, 1,
                                          cutoff_cm1=sc.cutoff_cm1)
                 if halo else sh.pad_lines_for_mesh(sc.lines, 1))
        f = sh.sharded_radiance_fn(
            mesh, win_grid=nu_off, win_lines=lines.nu0.cpu().double().numpy(),
            cutoff_cm1=sc.cutoff_cm1, nu_halo=halo)
        sts = [sh.stage_sharded(mesh, t(sc.nu_host), lines, cg,
                                nu_off=t(nu_off)) for cg in cgs]
        calls = [(lambda st: lambda g: g(st.nu, st.nu_off, st.lines, st.cg))(
            st) for st in sts]
        out = replays(f"(1, 1, 1) mesh forward, {tier} tier", f, calls, "K1")
        err = float((out[0] - ref).abs().max())
        print(f"6c graph: (1, 1, 1) {tier} replay vs single-device: max "
              f"|err| {err:.3e} of max {float(ref.abs().max()):.3e}")
        np.testing.assert_allclose(out[0].cpu().numpy(), ref.cpu().numpy(),
                                   rtol=MESH_RTOL,
                                   atol=MESH_RTOL * float(ref.abs().max()))
        # The walls, graph and eager body in turns (3 rounds each).
        walls = {"graph": [], "eager": []}
        for order in (("graph", "eager"), ("eager", "graph"),
                      ("graph", "eager")):
            for d in order:
                g = f if d == "graph" else f.body
                walls[d].append(cuda_ms(lambda: calls[0](g)))
        issue = {d: host_ms(lambda: calls[0](f if d == "graph" else f.body))
                 for d in walls}
        print(f"time (1, 1, 1) mesh forward, {tier} tier [{card}]: graph "
              f"{np.median(walls['graph']):.3f} ms, eager body "
              f"{np.median(walls['eager']):.3f} ms (CUDA events, median of "
              f"3 rounds of 5 in turns: graph "
              f"{', '.join(f'{v:.3f}' for v in walls['graph'])}; eager "
              f"{', '.join(f'{v:.3f}' for v in walls['eager'])}); host "
              f"issue / to the device's end a call: graph "
              f"{issue['graph'][0]:.3f} / {issue['graph'][1]:.3f} ms, eager "
              f"{issue['eager'][0]:.3f} / {issue['eager'][1]:.3f} ms")

    nu_b, mine = halo_in
    mine2 = mine._replace(amps=mine.amps * 0.5, y=mine.y * 1.25)
    calls = [(lambda m: lambda g: g(nu_b, m))(m) for m in (mine, mine2)]
    halo_fn.release()
    replays("the K3 halo accumulation", halo_fn, calls, "K3")
    capture_ring_check(mesh, sts[0].lines, card)


def capture_ring_check(mesh, lines_loc, card: str) -> None:
    """Phase 6c, the transport of a captured nu-halo exchange (route B:
    the ring kernel over the mesh's capture ring, its epochs counted on
    the card) on this card's loopback ring of 4 shards: the slice's packed
    line messages (``collectives.pack_messages``) moved in both directions
    by one launch, eagerly and through a CUDA graph replayed 3 times on
    new blocks, each bit-equal to the two rolls, with the count of calls
    read back from the card after each.  Prints, on a line of its own, the
    NCCL runtime, the route and the capture rings' settings as read
    back."""
    from spectrobot_tpu_torch.parallel import collectives as C
    from spectrobot_tpu_torch.parallel import cuda_dma
    from spectrobot_tpu_torch.parallel.peer import Ring
    from spectrobot_tpu_torch.parallel.sharded import _line_messages

    dev = mesh.device
    sends = [torch.stack(m) for m in _line_messages(lines_loc)]
    n_floats = C.packed_floats(sends)
    ring = Ring(4, dev, on_device=True)
    ring.reserve(n_floats)
    g = torch.Generator(device=dev).manual_seed(18)
    x = torch.randn((4, 1, n_floats), generator=g, device=dev)
    rolls = lambda v: torch.stack([torch.roll(v, 1, 0), torch.roll(v, -1, 0)])
    reset_launches()
    got = cuda_dma.ring_exchange_hops(ring, x, (1, -1))
    torch.cuda.synchronize()
    expect_launches("an eager two-direction ring call", launch_counts(),
                    dma_ring=1)
    check(torch.equal(got, rolls(x)), "the two-direction ring call differs "
          "from the rolls")
    calls = [ring.device_calls()]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cuda_dma.ring_exchange_hops(ring, x, (1, -1))
    calls.append(ring.device_calls())
    for i in range(3):
        x.copy_(torch.randn(x.shape, generator=g, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(out, rolls(x)),
              f"replay {i} of the captured ring call differs from the rolls")
        calls.append(ring.device_calls())
    check(calls == [1, 1, 2, 3, 4], f"the ring's count of calls on the card "
          f"read back {calls}, not [1, 1, 2, 3, 4]")
    del graph
    ring.close()
    mr = mesh.capture_ring
    print("6c capture: " + json.dumps({
        "nccl_runtime": ".".join(map(str, torch.cuda.nccl.version())),
        "route": "B: the captured exchange leaves NCCL for the ring kernel "
                 "over the mesh's capture ring (ncclConfig_t has no "
                 "per-communicator graph-mixing field)",
        "mesh_capture_ring": {
            "ranks": mr.ranks, "on_device": mr.on_device,
            "workspace_open": mr.workspace is not None,
            "device_calls_read_back": mr.device_calls()},
        "loopback_check": {
            "shards": 4, "message_floats": n_floats, "card": card,
            "device_calls_read_back": calls,
            "eager_and_3_replays_bit_equal_to_rolls": True}}))


class K4Case(NamedTuple):
    name: str
    nu: torch.Tensor        # [P] grid
    windows: object         # cuda_opacity.Windows of the grid and lines
    nu_c: torch.Tensor      # [L]
    sx: torch.Tensor
    y: torch.Tensor
    C: tuple                # C1..C4, each [R, L]
    chi_b: Optional[torch.Tensor]

    def as_batch(self) -> K1Case:
        """The case as one live state of a K1Case (for the tier and region
        counts)."""
        one = lambda a: None if a is None else a[None]
        return K1Case(self.name, self.nu, self.windows, one(self.nu_c),
                      one(self.sx), one(self.y),
                      torch.ones(1, 1, device=self.nu.device),
                      one(self.chi_b))


def recording_engine(seen: list):
    """The kernel engine with a K4 that also records its inputs (the rows
    a single-state Jacobian gives it) in ``seen``."""
    from spectrobot_tpu_torch.ops import cuda_basis_single as cbs
    from spectrobot_tpu_torch.ops.cuda_basis import KERNELS

    def contract_single(nu, windows, nu_c, sx, y, *C, **kw):
        seen.append((nu, windows, nu_c, sx, y, C, kw["chi_b"]))
        return cbs.basis_contract_single(nu, windows, nu_c, sx, y, *C, **kw)

    return dataclasses.replace(KERNELS, name="record",
                               contract_single=contract_single)


def compare_k4(case: K4Case, k2: bool = False) -> dict:
    """K4 against its plain version (and, with ``k2``, against K2 at B = 1)
    within K2_REL of max|ref|."""
    from spectrobot_tpu_torch.ops.cuda_basis import basis_contract_batch
    from spectrobot_tpu_torch.ops.cuda_basis_single import (
        basis_contract_single, basis_contract_single_plain, row_groups)
    from spectrobot_tpu_torch.ops.cuda_single import segments

    cut = case.windows.cutoff_cm1
    args = (case.nu, case.windows, case.nu_c, case.sx, case.y, *case.C)
    got = basis_contract_single(*args, cutoff_cm1=cut, chi_b=case.chi_b)
    torch.cuda.synchronize()
    ref = basis_contract_single_plain(*args[:1], *args[2:], cutoff_cm1=cut,
                                      chi_b=case.chi_b)
    check(bool(torch.isfinite(got).all()), f"{case.name}: non-finite K4")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    R = case.C[0].shape[0]
    row = {"case": case.name, "lines": int(case.nu_c.shape[0]),
           "points": int(case.nu.shape[0]), "rows": R, "cutoff": cut,
           "chi": case.chi_b is not None, "segments": segments(case.windows),
           "row_groups": row_groups(R)[0], "max_abs_err": err,
           "max_ref": scale, "budget": f"{K2_REL:g}*max|ref|",
           "err_over_budget": err / (K2_REL * scale)}
    if k2:
        one = lambda a: None if a is None else a[None].contiguous()
        b1 = basis_contract_batch(case.nu, case.windows, one(case.nu_c),
                                  one(case.sx), one(case.y),
                                  *(one(c) for c in case.C), cutoff_cm1=cut,
                                  chi_b=one(case.chi_b))[0]
        row["vs_k2_b1_max_abs_err"] = float((got - b1).abs().max())
        check(row["vs_k2_b1_max_abs_err"] <= K2_REL * scale,
              f"{case.name}: K4 disagrees with K2 at B = 1")
    print(f"K4 vs plain: {json.dumps(row)}")
    check(err <= K2_REL * scale, f"{case.name}: K4 disagrees with the plain "
                                 f"version ({err:.3g} of max {scale:.3g})")
    return row


def config1_scene(device):
    """Acceptance config 1's lines (the port's ``co2_15um_band(j_max=30)``,
    float32) and grid (3001 points over 630-705 cm-1) on ``device``."""
    from spectrobot_tpu_torch.data.synth import co2_15um_band
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist
    ll = co2_15um_band(j_max=30)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=torch.float32,
                                    device=device)
    nu = torch.as_tensor(np.linspace(630.0, 705.0, 3001), dtype=torch.float32,
                         device=device)
    return ll, dl, nu


def config1_oracle(ll, nu_host: np.ndarray) -> np.ndarray:
    """Config 1's radiance by the independent float64 oracle
    (tests/golden/numpy_ref.py, numpy and scipy only)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        from golden import numpy_ref
    finally:
        sys.path.pop(0)
    from spectrobot_tpu_torch.data import tips
    T = CONFIG1["T_layer"]
    q_ratio = np.full(len(ll), tips.q_of_T(2, 1, 296.0) / tips.q_of_T(2, 1, T))
    return numpy_ref.nadir_single_layer(
        nu_host, ll, T, CONFIG1["p_layer_pa"], CONFIG1["column_m2"],
        CONFIG1["vmr_self"], CONFIG1["T_surface"], q_ratio, cutoff=25.0)


def column_errors(J, J_ref) -> float:
    """The largest column error of a Jacobian (a tuple of columns, one per
    argument) over that column's max|ref|, in units of K2_REL."""
    return max(float((g - r).abs().max()) / (K2_REL * float(r.abs().max()))
               for g, r in zip(J, J_ref))


def single_state_phase(dev, cases3: dict, scene, *, dense_lines=20480,
                       dense_points=16384) -> dict:
    """Phase 6d: the single-state line sum (ops.opacity.make_accumulate_op
    at one state) through its entry points: config 1 (radiance: K3; its
    Jacobian: one K3 and one K4), the dense shape's cross sections and
    their Jacobian (K4 at R = 6), K4 at R = 66 on the dense shape, the
    deepest bench state and the deepest nadir state with chi, the
    structural route (cross_sections_batch over the slice's 32 layers: K1;
    its Jacobian: K1 and K2) and reverse mode (K3 and K5 at B = 1).
    Returns K4's rows, cases and the config-1 Jacobian's launches."""
    from spectrobot_tpu_torch.data.lines import random_lines
    from spectrobot_tpu_torch.forward.model import nadir_single_layer
    from spectrobot_tpu_torch.ops import cuda_basis as cb
    from spectrobot_tpu_torch.ops import cuda_opacity as co
    from spectrobot_tpu_torch.ops.opacity import (
        cross_sections, cross_sections_batch, line_kernel_inputs)
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist

    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    out = {"cases": {}, "rows": {}}

    # Config 1: the radiance through K3, against the plain engine and the
    # float64 oracle; its Jacobian through one K3 and one K4.
    ll, dl, nu = config1_scene(dev)
    x = [f32(v) for v in CONFIG1.values()]
    rad = lambda engine: (lambda *a: nadir_single_layer(nu, dl, *a,
                                                        engine=engine))
    reset_launches()
    I = rad(None)(*x)
    torch.cuda.synchronize()
    expect_launches("the config-1 radiance", launch_counts(), K3=1)
    I_plain = rad(cb.PLAIN)(*x)
    golden = config1_oracle(ll, nu.double().cpu().numpy())
    I_host = I.double().cpu().numpy()
    err_plain = float((I - I_plain).abs().max())
    err_gold = np.abs(I_host - golden)
    worst = float((err_gold / (ORACLE_RTOL * np.abs(golden) + ORACLE_ATOL_REL
                               * np.abs(golden).max())).max())
    print(f"config 1 radiance [3001]: K3 vs plain max |err| {err_plain:.3e} "
          f"of max {float(I_plain.abs().max()):.3e}; vs the float64 oracle "
          f"max |err| {float(err_gold.max()):.3e}, {worst:.3e} x its budget "
          f"({ORACLE_RTOL:g}*|ref| + {ORACLE_ATOL_REL:g}*max|ref|)")
    check(bool(torch.isfinite(I).all()), "config 1: non-finite radiance")
    np.testing.assert_allclose(I_host, I_plain.double().cpu().numpy(),
                               rtol=1e-4, atol=1e-5 * float(I_plain.max()))
    check(worst <= 1.0, "config 1 disagrees with the float64 oracle")
    argn = tuple(range(len(x)))
    reset_launches()
    J = torch.func.jacfwd(rad(None), argnums=argn)(*x)
    torch.cuda.synchronize()
    n = launch_counts()
    print(f"config 1 Jacobian (5 columns): launches {json.dumps(n)}")
    expect_launches("the config-1 Jacobian", n, K3=1, K4=1)
    out["config1_jac_launches"] = n["K4"]
    J_plain = torch.func.jacfwd(rad(cb.PLAIN), argnums=argn)(*x)
    ratio = column_errors(J, J_plain)
    print(f"config 1 Jacobian kernels vs plain: worst column error "
          f"{ratio:.3e} x {K2_REL:g} of its max|ref|")
    check(ratio <= 1.0, "the config-1 Jacobian disagrees with the plain one")
    out["config1_jac_ms"] = cuda_ms(
        lambda: torch.func.jacfwd(rad(None), argnums=argn)(*x))
    seen = []
    torch.func.jacfwd(rad(recording_engine(seen)), argnums=argn)(*x)
    cases = [K4Case(f"config 1, R = {seen[0][5][0].shape[0]}", *seen[0])]

    # The dense shape (bench.py:bench_kernel): cross sections through K3,
    # their Jacobian over (T, p, p_self) through K4 at R = 6.
    dd = device_lines_from_linelist(
        random_lines(dense_lines, 600.0, 740.0, seed=0), [(2, 1)],
        dtype=torch.float32, device=dev, nu_ref=0.0)
    nud = torch.as_tensor(np.linspace(640.0, 700.0, dense_points),
                          dtype=torch.float32, device=dev)
    xs = lambda engine: (lambda T, p, ps: torch.stack(cross_sections(
        nud, dd, T, p, ps, cutoff_cm1=None, nu_off=nud, engine=engine)))
    xd = [f32(220.0), f32(300.0), f32(100.0)]
    reset_launches()
    Jd = torch.func.jacfwd(xs(None), argnums=(0, 1, 2))(*xd)
    torch.cuda.synchronize()
    n = launch_counts()
    print(f"dense cross sections Jacobian (3 columns, {dense_lines} lines x "
          f"{dense_points} points): launches {json.dumps(n)}")
    expect_launches("the dense Jacobian", n, K3=1, K4=1)
    ratio = column_errors(Jd, torch.func.jacfwd(xs(cb.PLAIN),
                                                argnums=(0, 1, 2))(*xd))
    print(f"dense Jacobian kernels vs plain: worst column error {ratio:.3e} "
          f"x {K2_REL:g} of its max|ref|")
    check(ratio <= 1.0, "the dense Jacobian disagrees with the plain one")
    seen.clear()
    torch.func.jacfwd(xs(recording_engine(seen)), argnums=(0, 1, 2))(*xd)
    win, C = seen[0][1], seen[0][5]
    check(C[0].shape[0] == 6, f"the dense Jacobian gave K4 {C[0].shape[0]} "
                              f"rows, not 6")
    cases.append(K4Case("dense, R = 6", *seen[0]))
    kl = line_kernel_inputs(dd, 220.0, 300.0, 100.0,
                            amp_weights=torch.ones(2, dd.n_lines, device=dev))
    dense3 = K3Case("dense", nud, win, *(a.contiguous() for a in kl[:4]),
                    None)
    # K4 at R = 66 on random rows: the dense shape (also against K2 at
    # B = 1), the deepest bench state and the deepest nadir state with chi.
    for seed, (name, c3) in enumerate((
            ("dense", dense3), ("bench state", cases3["bench state"]),
            ("nadir state + chi", cases3["nadir state, 4 rows"]))):
        c3 = c3._replace(amps=c3.amps[:2].contiguous())
        C = [c[0] for c in coefficient_rows(c3.as_batch(), K2_COLUMNS,
                                            200 + seed)]
        cases.append(K4Case(f"{name}, R = {2 * K2_COLUMNS}", c3.nu,
                            c3.windows, c3.nu_c, c3.sx, c3.y, tuple(C),
                            c3.chi_b))
    tiers = {name: 0 for name in co.TIERS}
    for case in cases:
        b = case.as_batch()
        for k, v in co.tier_counts(case.windows, *b[3:7]).items():
            tiers[k] += v
        out["rows"][case.name] = compare_k4(case, k2=case.name.startswith(
            "dense, R = 66"))
        out["cases"][case.name] = case
    print(f"K4 tiers over its cases: {json.dumps(tiers)}")
    check(all(v > 0 for v in tiers.values()),
          f"not every Voigt tier was exercised by K4: {tiers}")

    # The structural route: cross_sections_batch over the slice's 32 layer
    # states (a vmap of cross_sections) runs K1; its Jacobian over the 32
    # layer temperatures K1 and K2 (R = 64).
    atm = scene.atm.to(torch.float32)
    T_lay = 0.5 * (atm.T[1:] + atm.T[:-1])
    p_lay = torch.sqrt(atm.p[1:] * atm.p[:-1])
    ps_lay = 0.5 * (atm.vmr["CO2"][1:] + atm.vmr["CO2"][:-1]) * p_lay
    xb = lambda engine: (lambda T: torch.stack(cross_sections_batch(
        scene.nu, scene.lines, T, p_lay, ps_lay, nu_off=scene.nu_off,
        engine=engine)))
    reset_launches()
    S = xb(None)(T_lay)
    torch.cuda.synchronize()
    n = launch_counts()
    print(f"cross_sections_batch ({T_lay.shape[0]} layers): launches "
          f"{json.dumps(n)}")
    expect_launches("cross_sections_batch", n, K1=1)
    S_plain = xb(cb.PLAIN)(T_lay)
    err = (S - S_plain).abs()
    worst = float((err / (RTOL * S_plain.abs() + ATOL_REL
                          * S_plain.abs().max())).max())
    check(worst <= 1.0, "cross_sections_batch disagrees with the plain one")
    reset_launches()
    Jb = torch.func.jacfwd(xb(None))(T_lay)
    torch.cuda.synchronize()
    n = launch_counts()
    rows = []
    rec = dataclasses.replace(cb.KERNELS, contract=lambda *a, **kw: (
        rows.append(a[5].shape[1]), cb.KERNELS.contract(*a, **kw))[1])
    torch.func.jacfwd(xb(rec))(T_lay)
    print(f"cross_sections_batch Jacobian ({T_lay.shape[0]} columns): "
          f"launches {json.dumps(n)}, K2 rows {rows}; kernels vs plain "
          f"{worst:.3e} x K1's budget (values)")
    expect_launches("the cross_sections_batch Jacobian", n, K1=1, K2=1)
    check(rows == [2 * T_lay.shape[0]], f"K2 took rows {rows}")
    Jb_plain = torch.func.jacfwd(xb(cb.PLAIN))(T_lay)
    jerr = float((Jb - Jb_plain).abs().max())
    check(jerr <= K2_REL * float(Jb_plain.abs().max()),
          "the cross_sections_batch Jacobian disagrees with the plain one")

    # Reverse mode: the gradient of a scalar of config 1's cross sections
    # (K3 and K5 at B = 1) against the jacfwd columns (K3 and K4) contracted
    # with the same weights, within ADJ_REL of the sum of absolute terms.
    w = torch.as_tensor(np.random.default_rng(9).normal(size=nu.shape[0]),
                        dtype=torch.float32, device=dev)
    sig = lambda mode: (lambda T, p, ps: cross_sections(
        nu, dl, T, p, ps, analytic_jvp=mode)[0])
    xr = [f32(CONFIG1["T_layer"]), f32(CONFIG1["p_layer_pa"]),
          f32(CONFIG1["vmr_self"] * CONFIG1["p_layer_pa"])]
    args = [v.clone().requires_grad_() for v in xr]
    reset_launches()
    g = torch.autograd.grad((sig("rev")(*args) * w).sum(), args)
    torch.cuda.synchronize()
    n = launch_counts()
    Jc = torch.stack(torch.func.jacfwd(sig(True), argnums=(0, 1, 2))(*xr))
    g_ref = (Jc.double() * w.double()).sum(1)
    scale = (Jc.double() * w.double()).abs().sum(1)
    ratio = float(((torch.stack(g).double() - g_ref).abs()
                   / (ADJ_REL * scale)).max())
    print(f"reverse gradient of a config-1 cross-section scalar: launches "
          f"{json.dumps(n)}; vs the jacfwd columns: |diff| over {ADJ_REL:g} "
          f"x the sum of absolute terms {ratio:.3e} (T, p, p_self: "
          f"{', '.join(f'{float(v):.6e}' for v in g)})")
    expect_launches("the single-state reverse gradient", n, K3=1, K5=1)
    check(ratio <= 1.0,
          "the single-state reverse gradient disagrees with the jacfwd row")
    return out


# Acceptance config 3 at full width: examples/mars_limb.toml's geometry
# (20 rays 5-89 km, 33 levels, n_sub 4, cutoff 25) on the 4.3 um band with
# prescribed vibrational populations; the composed scene adds the CIA
# continuum and the field of view (40 fine rays smeared into the 20).
CONFIG3_CLI = {"grid.nu_min": "2280.0", "grid.nu_max": "2400.0",
               "lines.source": "synthetic:co2_43um,co2_43um_hot",
               "nlte.enabled": "true", "nlte.t_vib": "demo:co2_pump"}
COMPOSED_CLI = {**CONFIG3_CLI, "cia.enabled": "true",
                "instrument.fov_fwhm_km": "3.0",
                "instrument.fov_n_fine": "40"}


def _cli_args(overrides: dict) -> list:
    return [a for k, v in overrides.items() for a in ("-o", f"{k}={v}")]


def config3_oracle(dev) -> dict:
    """The small config-3 scene of tests/test_nlte_config3.py (16 levels,
    801 points over 2320-2360 cm-1, two limb rays) through K1 in float32,
    against the float64 oracle (tests/golden/numpy_ref.py) under config
    1's budget."""
    from spectrobot_tpu_torch.constants import C2
    from spectrobot_tpu_torch.data import nlte, synth, tips
    from spectrobot_tpu_torch.data.atmosphere import (
        MARS, mars_standard_atmosphere)
    from spectrobot_tpu_torch.forward.geometry import limb_path_cg
    from spectrobot_tpu_torch.forward.limb import limb_radiance
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist

    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        from golden import numpy_ref
    finally:
        sys.path.pop(0)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    atm = mars_standard_atmosphere(n_lev=16, z_top=90e3, device=dev)
    ll = synth.co2_43um_band(j_max=15).concat(
        synth.co2_43um_hot_band(j_max=10))
    reg = nlte.registry_from_linelist(ll)
    ll = nlte.match_lines_to_levels(ll, reg)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=torch.float32,
                                    device=dev)
    z, T = atm.z.cpu().numpy(), atm.T.cpu().numpy()
    z_mid = 0.5 * (z[1:] + z[:-1])
    T_lay = np.interp(z_mid, z, T)
    t_vib = nlte.lte_t_vib(reg, T_lay)
    boost = 1.0 + 0.35 * np.clip((z_mid - 50e3) / 40e3, 0.0, 1.0)
    for i, (_, _, q) in enumerate(reg.keys):
        if q in ("0001", "0111"):
            t_vib[i] = T_lay * boost
    state = nlte.device_nlte(reg, t_vib, dtype=torch.float32, device=dev)
    nu_host = np.linspace(2320.0, 2360.0, 801)
    h_t = np.array([40e3, 70e3])
    cg = limb_path_cg(atm.to(torch.float32), ["CO2"], f32(h_t), MARS, 4)
    reset_launches()
    got = limb_radiance(f32(nu_host), dl, cg, nlte=state,
                        nu_off=f32(nu_host - float(dl.nu_ref)),
                        cutoff_cm1=25.0)
    torch.cuda.synchronize()
    n = launch_counts()
    got = got.double().cpu().numpy()
    e_lvl = np.asarray(reg.energies_cm1)

    def q_ratio_fn(name, T_):
        return np.full(len(ll), tips.q_of_T(2, 1, 296.0)
                       / tips.q_of_T(2, 1, T_))

    def nlte_weights_fn(name, lay, T_kin):
        r = np.exp(-C2 * e_lvl * (1 / t_vib[:, lay] - 1 / T_kin))
        r_u = np.where(ll.level_upper >= 0,
                       r[np.maximum(ll.level_upper, 0)], 1.0)
        r_l = np.where(ll.level_lower >= 0,
                       r[np.maximum(ll.level_lower, 0)], 1.0)
        E = np.exp(-C2 * ll.nu0 / T_kin)
        return (r_l - r_u * E) / (1 - E), r_u

    ref = np.stack([numpy_ref.limb_radiance(
        nu_host, {"CO2": ll}, z, atm.p.cpu().numpy(), T,
        atm.n.cpu().numpy(), {k: v.cpu().numpy() for k, v in atm.vmr.items()},
        MARS.radius_m, ht, ["CO2"], q_ratio_fn, cutoff=25.0, n_sub=4,
        nlte_weights_fn=nlte_weights_fn) for ht in h_t])
    err = np.abs(got - ref)
    worst = float((err / (ORACLE_RTOL * np.abs(ref)
                          + ORACLE_ATOL_REL * np.abs(ref).max())).max())
    print(f"config 3 (16 levels, 801 points, 2 rays) through K1 vs the "
          f"float64 oracle: max |err| {float(err.max()):.3e} of max "
          f"{float(np.abs(ref).max()):.3e}, {worst:.3e} x the budget "
          f"({ORACLE_RTOL:g}*|ref| + {ORACLE_ATOL_REL:g}*max|ref|); "
          f"launches {json.dumps(n)}")
    expect_launches("the config-3 oracle scene", n, K1=1)
    check(bool(np.isfinite(got).all()), "non-finite config-3 radiances")
    check(worst <= 1.0, "config 3 disagrees with the float64 oracle")
    return {"err_over_budget": worst}


def recording_engine_rows(seen: dict):
    """The kernel engine, recording K2's coefficient rows and K5's
    cotangent rows as the main path gives them (its launches are not
    counted: the counts are reset before each counted run)."""
    from spectrobot_tpu_torch.ops import cuda_transpose as ctr
    from spectrobot_tpu_torch.ops.cuda_basis import (
        KERNELS, basis_contract_batch)
    from spectrobot_tpu_torch.ops.opacity import Engine

    def contract(nu, windows, nu_c, sx, y, C1, C2, C3, C4, *args, **kw):
        seen["C"] = tuple(c.detach().contiguous() for c in (C1, C2, C3, C4))
        return basis_contract_batch(nu, windows, nu_c, sx, y, C1, C2, C3, C4,
                                    *args, **kw)

    def transpose(nu, windows, nu_c, sx, y, ct, **kw):
        seen["ct"] = ct.detach().contiguous()
        return ctr.basis_transpose_batch(nu, windows, nu_c, sx, y, ct, **kw)

    return Engine("record", KERNELS.accumulate, contract, transpose,
                  KERNELS.transpose_rows)


def config3_phase(dev, mesh) -> dict:
    """Phase 6f: acceptance config 3 and the composed features at full
    width, float32 on the card.  ``mesh``: the (1, 1, 1) mesh of phase
    6c.  Returns what phase 7 times and reports."""
    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch import halo_overlap as ho
    from spectrobot_tpu_torch.ops.cuda_basis import KERNELS, PLAIN
    from spectrobot_tpu_torch.parallel import graphed
    from spectrobot_tpu_torch.retrieval.state import flatten_state, make_state

    out = {"oracle": config3_oracle(dev)}
    cfg = cli.load_config(SCENE, CONFIG3_CLI)
    scene = cli.build_scene(cfg, dev)
    check(scene.nlte is not None
          and bool((scene.lines.level_upper >= 0).all()),
          "config 3 staged lines without their level indices")

    # K1, K2 and K5 on the scene's own inputs: the forward's rows (w_abs u
    # and w_em u), the Jacobian's coefficient rows and the gradient's
    # cotangent rows (recorded by an engine whose launches are not counted).
    base = line_sum_inputs(lambda e: cli.run_forward(cfg, scene, e))
    case = K1Case("config3", *base, None)
    amps = case.amps
    live = amps.flatten(1).ne(0).any(1)
    diff = (amps[:, 0] - amps[:, 1]).abs().amax(dim=1)
    n_differ = int((diff > 1e-3 * amps.abs().amax(dim=(1, 2))).sum())
    print(f"config 3 rows: {int(live.sum())} of {amps.shape[0]} states live, "
          f"{n_differ} with w_abs u != w_em u (> 1e-3 of the state's max), "
          f"{case.nu_c.shape[1]} lines, {case.nu.shape[0]} points")
    check(n_differ > 0, "config 3 gave K1 equal absorption and emission rows")
    out["k1"] = compare_k1(case)
    seen = {}
    rec = cli.retrieval_problem(cfg, scene, recording_engine_rows(seen))
    n_x = int(rec.x0.shape[0])
    # Eagerly: a CUDA graph's capture would record rows it never computes.
    cli.make_jacobian(cfg, rec.fwd_flat, n_x, scene.nu.shape[0],
                      dev, graph=False)(rec.x0)
    out["k2"] = compare_k2(case, seen["C"])
    check(seen["C"][0].shape[1] == 2 * n_x,
          f"the config-3 Jacobian gave K2 {seen['C'][0].shape[1]} rows")

    # The CLI forward: one K1 launch for the whole scan.
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        cli.main(["forward", SCENE, *_cli_args(CONFIG3_CLI), "-o",
                  f"run.output_dir={tmp}", "--device", "cuda"])
        n = launch_counts()
        with np.load(os.path.join(tmp, "forward.npz")) as f:
            I = f["values"]
    print(f"config 3 CLI forward: {I.shape} radiances, max {I.max():.4e}; "
          f"launches {json.dumps(n)}")
    expect_launches("the config-3 CLI forward", n, K1=1)
    check(I.shape == (20, 96) and bool(np.isfinite(I).all()
                                       and (I >= 0).all()),
          "config-3 radiances not finite and non-negative, or misshapen")

    # The Jacobian at the prior: one K1 and one K2 launch, against the
    # plain engine's.
    prob = {e.name: cli.retrieval_problem(cfg, scene, e)
            for e in (KERNELS, PLAIN)}
    jac = {k: cli.make_jacobian(cfg, p.fwd_flat, n_x, scene.nu.shape[0], dev)
           for k, p in prob.items()}
    x0 = prob["kernels"].x0
    out["jac_peak"] = peak_memory(lambda: jac["kernels"](x0))
    reset_launches()
    J = jac["kernels"](x0)
    torch.cuda.synchronize()
    n = launch_counts()
    J_plain = jac["plain"](x0)
    err, jmax = float((J - J_plain).abs().max()), float(J_plain.abs().max())
    print(f"config 3 Jacobian {tuple(J.shape)} kernels vs plain: max |err| "
          f"{err:.3e} of max |K| {jmax:.3e} ({err / jmax:.3e}); launches "
          f"{json.dumps(n)}")
    expect_launches("the config-3 Jacobian", n, K1=1, K2=1)
    check(bool(torch.isfinite(J).all()), "non-finite config-3 Jacobian")
    check(err <= K2_REL * jmax,
          "the config-3 kernel Jacobian disagrees with the plain one")
    del J_plain

    # The CLI retrieve: converged, chi2 falling, one K2 per Jacobian.
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        cli.main(["retrieve", SCENE, *_cli_args(CONFIG3_CLI), "-o",
                  f"run.output_dir={tmp}", "--device", "cuda"])
        n = launch_counts()
        with np.load(os.path.join(tmp, "retrieval.npz")) as f:
            res = {k: f[k] for k in f.files}
        with open(os.path.join(tmp, "run.jsonl")) as f:
            iters = [r for r in map(json.loads, f) if "chi2" in r]
    n_iter = int(res["n_iter"])
    print(f"config 3 CLI retrieve: converged {bool(res['converged'])} "
          f"({res['stop_reason']}), chi2 {iters[0]['chi2']:.6g} at the "
          f"prior -> {float(res['chi2']):.6g} over {res['y_obs'].size} "
          f"measurements, {n_iter} LM iterations; launches {json.dumps(n)}")
    check(bool(res["converged"]), "the config-3 retrieval did not converge")
    check(float(res["chi2"]) < iters[0]["chi2"], "config-3 chi2 did not fall")
    check(n["K1"] > 0 and n["K2"] == n_iter + 1 and n["K5"] == 0,
          "the config-3 retrieve did not run one K2 per Jacobian")
    check(all(bool(np.isfinite(v).all()) for v in res.values()
              if v.dtype.kind == "f"), "config-3 retrieval.npz non-finite")
    out["iter_walls"] = [r["wall_s"] for r in iters]

    # The reverse gradient of the retrieval cost: one K1 and one K5 launch,
    # against J^T dL/dy; then K5 on the cotangent rows it gave.
    y_obs = torch.as_tensor(res["y_obs"].reshape(-1), dtype=torch.float32,
                            device=dev)
    sigma = torch.as_tensor(res["noise"].reshape(-1), dtype=torch.float32,
                            device=dev)

    def cost_grad(p):
        x = p.x0.detach().clone().requires_grad_()
        r = (p.fwd_flat(x) - y_obs) / sigma
        return torch.autograd.grad(0.5 * torch.sum(r * r), x)[0]

    rev = cli.retrieval_problem(cfg, scene, KERNELS, analytic_jvp="rev")
    reset_launches()
    g = cost_grad(rev)
    torch.cuda.synchronize()
    n = launch_counts()
    # At config 3's prior the residual is mostly noise, so the gradient's
    # terms J_ij r_i / sigma_i^2 cancel (|g| ~ sqrt(n_y) of their absolute
    # sum): the float32 roundoff of both sides scales with that sum, which
    # the budget's absolute part takes as its scale (as the adjoint
    # identity's does).  J^T dL/dy is formed in float64 from J.
    w = ((prob["kernels"].fwd_flat(x0) - y_obs) / sigma ** 2).double()
    g_jac = J.double().T @ w
    terms = float((J.double().abs().T @ w.abs()).max())
    g_err = (g.double() - g_jac).abs()
    ok = bool(torch.all(g_err <= GRAD_RTOL * g_jac.abs()
                        + GRAD_ATOL_REL * terms))
    print(f"config 3 reverse gradient vs J^T dL/dy: max |err| "
          f"{float(g_err.max()):.3e} of max |g| "
          f"{float(g_jac.abs().max()):.3e}, largest sum of absolute terms "
          f"{terms:.3e} (budget {GRAD_RTOL:g}*|ref| + {GRAD_ATOL_REL:g}*"
          f"that sum): {'ok' if ok else 'FAILED'}; launches "
          f"{json.dumps(n)}")
    expect_launches("the config-3 reverse gradient", n, K1=1, K5=1)
    check(ok and bool(torch.isfinite(g).all()),
          "the config-3 reverse gradient disagrees with J^T dL/dy")
    cost_grad(cli.retrieval_problem(cfg, scene, recording_engine_rows(seen),
                                    analytic_jvp="rev"))
    out["k5"] = compare_k5(case, seen["ct"])
    out.update(cfg=cfg, scene=scene, jac=jac["kernels"], x0=x0,
               fwd=prob["kernels"].fwd_flat, n_x=n_x, case=case, C=seen["C"],
               ct=seen["ct"], I=I, J=J)

    # The composed scene: non-LTE x CIA x FOV (40 fine rays, 20 observed).
    cfg_c = cli.load_config(SCENE, COMPOSED_CLI)
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        cli.main(["forward", SCENE, *_cli_args(COMPOSED_CLI), "-o",
                  f"run.output_dir={tmp}", "--device", "cuda"])
        n = launch_counts()
        with np.load(os.path.join(tmp, "forward.npz")) as f:
            I_c = f["values"]
        print(f"composed CLI forward: {I_c.shape} radiances (40 fine rays), "
              f"max |diff| from config 3 {np.abs(I_c - I).max():.3e} of "
              f"{I.max():.3e}; launches {json.dumps(n)}")
        expect_launches("the composed CLI forward", n, K1=1)
        check(I_c.shape == (20, 96) and bool(np.isfinite(I_c).all()
                                             and (I_c >= 0).all()),
              "composed radiances not finite and non-negative, or misshapen")
        reset_launches()
        cli.main(["retrieve", SCENE, *_cli_args(COMPOSED_CLI), "-o",
                  f"run.output_dir={tmp}", "--device", "cuda"])
        n = launch_counts()
        with np.load(os.path.join(tmp, "retrieval.npz")) as f:
            res_c = {k: f[k] for k in f.files}
        with open(os.path.join(tmp, "run.jsonl")) as f:
            iters_c = [r for r in map(json.loads, f) if "chi2" in r]
    print(f"composed CLI retrieve: converged {bool(res_c['converged'])} "
          f"({res_c['stop_reason']}), chi2 {iters_c[0]['chi2']:.6g} -> "
          f"{float(res_c['chi2']):.6g}, {int(res_c['n_iter'])} LM "
          f"iterations; launches {json.dumps(n)}")
    check(float(res_c["chi2"]) < iters_c[0]["chi2"],
          "composed chi2 did not fall")
    check(all(bool(np.isfinite(v).all()) for v in res_c.values()
              if v.dtype.kind == "f"), "composed retrieval.npz non-finite")
    scene_c = cli.build_scene(cfg_c, dev)
    prob_c = cli.retrieval_problem(cfg_c, scene_c, KERNELS)
    jac_c = cli.make_jacobian(cfg_c, prob_c.fwd_flat, n_x,
                              scene_c.nu.shape[0], dev)
    got = []
    reset_launches()
    peak = out["composed_jac_peak"] = peak_memory(
        lambda: got.append(jac_c(prob_c.x0)))
    n = launch_counts()
    J_c = got.pop()
    print(f"composed Jacobian {tuple(J_c.shape)}: finite "
          f"{bool(torch.isfinite(J_c).all())}, max |K| "
          f"{float(J_c.abs().max()):.3e}; peak device memory {peak[0]:.2f} "
          f"GB ({peak[1]:.2f} GB resident before it); launches "
          f"{json.dumps(n)}")
    expect_launches("the composed Jacobian", n, K1=1, K2=1)
    check(bool(torch.isfinite(J_c).all()), "non-finite composed Jacobian")

    # The (1, 1, 1) mesh in the nu-halo tier against one device.
    cfg_h = cli.load_config(SCENE, {**COMPOSED_CLI,
                                    "compute.mesh_halo": "true"})
    empty = make_state(scene_c.atm, [], retrieve_temperature=False)
    I_single = cli.run_forward(cfg_c, scene_c).cpu().numpy()
    oe = cli.sharded_problem(cfg_h, scene_c, mesh, scene_c.atm, empty)
    pool = graphed.pool_bytes()
    reset_launches()
    I_m = oe.forward_flat(flatten_state(empty)[0]).reshape(I_single.shape)
    torch.cuda.synchronize()
    n = launch_counts()
    pool = graphed.pool_bytes() - pool
    # The second call replays the graph its first call captured; its
    # counts are held to the kernels its trace shows.
    reset_launches()
    traced, I_r = ho.traced_launches(
        lambda: oe.forward_flat(flatten_state(empty)[0]), dev)
    I_r = I_r.reshape(I_single.shape)
    n_r = launch_counts()
    check(traced == launch.LAUNCHES,
          f"the composed mesh forward's replay traced {json.dumps(traced)}, "
          f"its counts say {json.dumps(launch.LAUNCHES)}")
    print(f"composed mesh forward replayed: bit-equal to its first (eager) "
          f"call {bool(torch.equal(I_r, I_m))}; graph pool "
          f"{pool / 1e6:.2f} MB; launches {json.dumps(n_r)}, as its trace "
          f"shows")
    expect_launches("the composed mesh forward's replay", n_r, K1=1)
    check(torch.equal(I_r, I_m), "the composed mesh forward's replay "
                                 "differs from its first (eager) call")
    I_m = I_m.cpu().numpy()
    err = float(np.abs(I_m - I_single).max())
    print(f"composed mesh forward (nu-halo tier) vs single-device: max "
          f"|err| {err:.3e} of max {float(np.abs(I_single).max()):.3e}; "
          f"row axes {oe.row_axes}; launches {json.dumps(n)}")
    expect_launches("the composed mesh forward", n, K1=1)
    np.testing.assert_allclose(I_m, I_single, rtol=MESH_RTOL,
                               atol=MESH_RTOL * np.abs(I_single).max())
    return out


# The (P, T) table tier (phase 6g): examples/mars_limb.toml and config 3
# through their tables; the 2-D climatology sliced at 45 deg N.
LUT_CLI = {"compute.use_lut": "true"}
ZONAL_CLI = {"scene.atmosphere": "mars_zonal", "scene.latitude_deg": "45.0"}
# A table forward against the direct one: the reference's LUT budget
# (tests/test_cli_config.py:224-226), max |I_lut - I_dir| / max(I_dir,
# 1e-3 max I_dir) < LUT_REL.  The table's Jacobian against the direct one:
# max |dJ| <= LUT_JAC_REL max |J_dir| (tests/test_torch_lut.py measured
# 0.0128 in float64 on the CPU, on a 128-point cut of the scene).
LUT_REL = 0.05
LUT_JAC_REL = 0.05


def lut_rel(I_lut: np.ndarray, I_dir: np.ndarray) -> float:
    return float(np.max(np.abs(I_lut - I_dir)
                        / np.maximum(I_dir, 1e-3 * I_dir.max())))


def cli_run(cmd: str, overrides: dict, tmp: str) -> tuple:
    """``cmd`` of the CLI on examples/mars_limb.toml with ``overrides`` on
    the card: (the output .npz's arrays, the kernels' launches, the LM
    iterations' records of run.jsonl)."""
    from spectrobot_tpu_torch import cli

    reset_launches()
    cli.main([cmd, SCENE, *_cli_args(overrides), "-o",
              f"run.output_dir={tmp}", "--device", "cuda"])
    torch.cuda.synchronize()
    n = launch_counts()
    name = "forward.npz" if cmd == "forward" else "retrieval.npz"
    with np.load(os.path.join(tmp, name)) as f:
        res = {k: f[k] for k in f.files}
    iters = []
    if cmd == "retrieve":
        with open(os.path.join(tmp, "run.jsonl")) as f:
            iters = [r for r in map(json.loads, f) if "chi2" in r]
    return res, n, iters


def epilogue_counts() -> dict:
    """A copy of the RT epilogue's host-issued calls by route
    (``forward.limb.EPILOGUE_COUNTS``)."""
    from spectrobot_tpu_torch.forward import limb
    return dict(limb.EPILOGUE_COUNTS)


def epilogue_route(before: dict) -> str:
    """The route the epilogue's calls took since ``before``
    (:func:`epilogue_counts`): "fused" or "composed" where every call took
    it, "mixed" where both ran, "none" where no call was issued (a graph's
    replay)."""
    now = epilogue_counts()
    fused, composed = (now[k] - before[k] for k in ("fused", "composed"))
    if fused and composed:
        return "mixed"
    return "fused" if fused else "composed" if composed else "none"


def peak_memory(fn) -> tuple:
    """(peak, resident) device memory [GB] of one call of ``fn``: the
    allocator's peak over the call, and what was allocated before it;
    and the route its epilogue took (:func:`epilogue_route`)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    before = epilogue_counts()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() / 1e9, resident / 1e9,
            epilogue_route(before))


def table_error(built, plain) -> tuple:
    """(max |err|, the worst ratio to K1's budget) of a table against its
    plain build, over every node of every table; the budget's scale is
    the largest entry of them all (the build's one K1 call)."""
    from spectrobot_tpu_torch.ops import lut

    fields = (("sigma_l", "sigma_u", "sigma_e")
              if isinstance(built, lut.NLTELUT) else ("sigma",))
    scale = max(float(getattr(plain, f).abs().max()) for f in fields)
    err = worst = 0.0
    for f in fields:
        got, ref = getattr(built, f), getattr(plain, f)
        e = (got - ref).abs()
        err = max(err, float(e.max()))
        worst = max(worst, float((e / (RTOL * ref.abs()
                                       + ATOL_REL * scale)).max()))
    return err, worst


def lut_phase(dev, mesh, direct: dict) -> dict:
    """Phase 6g: the (P, T) table tier at full width, float32 on the card.
    ``direct``: the direct paths' outputs for each tier ("LTE": phase 5's
    CLI forward radiances and phase 6's Jacobian; "non-LTE": phase 6f's);
    ``mesh``: the (1, 1, 1) mesh of phase 6c.  Returns what phase 7
    times."""
    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch.ops import lut
    from spectrobot_tpu_torch.ops.cuda_basis import KERNELS, PLAIN
    from spectrobot_tpu_torch.retrieval.state import flatten_state, make_state

    out = {}
    for tier, ov in (("LTE", LUT_CLI), ("non-LTE", {**CONFIG3_CLI,
                                                    **LUT_CLI})):
        t = out[tier] = {"cfg": cli.load_config(SCENE, ov)}
        cfg = t["cfg"]
        # The build: one K1 launch, against the plain build at every node.
        reset_launches()
        scene = t["scene"] = cli.build_scene(cfg, dev)
        torch.cuda.synchronize()
        n = launch_counts()
        t["build"] = (lut.build_nlte_lut if scene.nlte is not None
                      else lut.build_lut)
        t["args"] = (scene.nu, scene.lines, len(scene.species_names))
        t["lattice"] = cli.lut_lattice(cfg, scene.atm, scene.species_names,
                                       scene.chi, scene.nu_off)
        t0 = time.perf_counter()
        plain = t["build"](*t["args"], engine=PLAIN, **t["lattice"])
        torch.cuda.synchronize()
        t["plain_s"] = time.perf_counter() - t0
        err, worst = table_error(scene.lut, plain)
        del plain
        t["k1"] = K1Case(f"{tier} table", *line_sum_inputs(
            lambda e: t["build"](*t["args"], engine=e, **t["lattice"])),
            None)
        B, L = t["k1"].nu_c.shape
        print(f"{tier} table build ({scene.lut_src}): {B} K1 states x {L} "
              f"lines x {scene.nu.shape[0]} points; vs the plain build at "
              f"every node max |err| {err:.3e}, {worst:.3e} x K1's budget; "
              f"launches {json.dumps(n)}")
        expect_launches(f"the {tier} table build", n, K1=1)
        check(worst <= 1.0, f"the {tier} table disagrees with its plain "
                            f"build")
        # The CLI forward (the build: one K1) against the direct one, then
        # again from the file it wrote (no launch at all).
        with tempfile.TemporaryDirectory() as tmp:
            ovp = {**ov, "compute.lut_path": os.path.join(tmp, "lut.npz")}
            res, n, _ = cli_run("forward", ovp, tmp)
            I = t["I"] = res["values"]
            rel = lut_rel(I, direct[tier]["I"])
            print(f"{tier} table CLI forward: {I.shape}, max {I.max():.4e}, "
                  f"vs the direct CLI forward {rel:.4f} (budget {LUT_REL}); "
                  f"launches {json.dumps(n)}")
            expect_launches(f"the {tier} table CLI forward", n, K1=1)
            check(bool(np.isfinite(I).all() and (I >= 0).all()),
                  f"{tier} table radiances not finite and non-negative")
            check(rel < LUT_REL, f"the {tier} table forward is off the "
                                 f"direct one")
            res, n, _ = cli_run("forward", ovp, tmp)
            print(f"{tier} table CLI forward from compute.lut_path: "
                  f"launches {json.dumps(n)}, radiances equal "
                  f"{bool(np.array_equal(res['values'], I))}")
            expect_launches(f"the {tier} cached-table CLI forward", n)
            check(bool(np.array_equal(res["values"], I)),
                  "the cached table gave other radiances")
        # The Jacobian through the table: no kernel, finite, its peak
        # memory beside the direct Jacobian's.
        prob = cli.retrieval_problem(cfg, scene, KERNELS)
        t["x0"] = prob.x0
        t["jac"] = cli.make_jacobian(cfg, prob.fwd_flat,
                                     int(prob.x0.shape[0]), scene.nu.shape[0],
                                     dev)
        t["fwd"] = prob.fwd_flat
        reset_launches()
        J = t["jac"](prob.x0)
        torch.cuda.synchronize()
        n = launch_counts()
        t["jac_peak"] = peak_memory(lambda: t["jac"](prob.x0))
        J_dir = direct[tier]["J"]
        jrel = float((J - J_dir).abs().max() / J_dir.abs().max())
        print(f"{tier} table Jacobian {tuple(J.shape)}: finite "
              f"{bool(torch.isfinite(J).all())}, vs the direct K1 + K2 "
              f"Jacobian max |dJ| {jrel:.4f} of max |J| (budget "
              f"{LUT_JAC_REL} for LTE); peak device memory "
              f"{t['jac_peak'][0]:.2f} GB ({t['jac_peak'][1]:.2f} GB "
              f"resident before it), the direct Jacobian's "
              f"{direct[tier]['jac_peak'][0]:.2f} GB "
              f"({direct[tier]['jac_peak'][1]:.2f} GB resident); launches "
              f"{json.dumps(n)}")
        expect_launches(f"the {tier} table Jacobian", n)
        check(bool(torch.isfinite(J).all()), f"non-finite {tier} table "
                                             f"Jacobian")
        check(tier != "LTE" or jrel <= LUT_JAC_REL,
              "the table Jacobian is off the direct one")
        # The CLI retrieve: K1 for the build alone, none per LM iteration.
        with tempfile.TemporaryDirectory() as tmp:
            res, n, iters = cli_run("retrieve", ov, tmp)
        print(f"{tier} table CLI retrieve: converged "
              f"{bool(res['converged'])} ({res['stop_reason']}), chi2 "
              f"{iters[0]['chi2']:.6g} at the prior -> "
              f"{float(res['chi2']):.6g}, {int(res['n_iter'])} LM "
              f"iterations; launches {json.dumps(n)}")
        expect_launches(f"the {tier} table CLI retrieve", n, K1=1)
        check(bool(res["converged"]), f"the {tier} table retrieval did not "
                                      f"converge")
        check(float(res["chi2"]) < iters[0]["chi2"],
              f"{tier} table chi2 did not fall")
        t["iter_walls"] = [r["wall_s"] for r in iters]
        t["obs"] = (res["y_obs"].reshape(-1), res["noise"].reshape(-1))

    # The (1, 1, 1) mesh: the lattice build over the group (NCCL) equal to
    # the serial table; the mesh table forward and normal equations
    # against one device.
    t = out["LTE"]
    cfg, scene = t["cfg"], t["scene"]
    reset_launches()
    shared = lut.build_lut(*t["args"], mesh=lut.lut_mesh(), **t["lattice"])
    torch.cuda.synchronize()
    n = launch_counts()
    same = bool(torch.equal(shared.sigma, scene.lut.sigma))
    world = torch.distributed.get_world_size()
    print(f"table build over the process group ({world} rank): bit-equal "
          f"to the serial table {same}; launches {json.dumps(n)}")
    expect_launches("the table build over the group", n, K1=1)
    check(same, "the group's table differs from the serial one")
    with tempfile.TemporaryDirectory() as tmp:
        res, n, _ = cli_run("forward", {**LUT_CLI,
                                        "compute.lut_build_mesh": "true"}, tmp)
    same = bool(np.array_equal(res["values"], t["I"]))
    print(f"table CLI forward with compute.lut_build_mesh: radiances equal "
          f"to the serial table's {same}; launches {json.dumps(n)}")
    expect_launches("the CLI forward with compute.lut_build_mesh", n, K1=1)
    check(same, "compute.lut_build_mesh changed the radiances")
    empty = make_state(scene.atm, [], retrieve_temperature=False)
    I_single = cli.run_forward(cfg, scene).cpu().numpy()
    oe = cli.sharded_problem(cfg, scene, mesh, scene.atm, empty)
    reset_launches()
    I_m = oe.forward_flat(flatten_state(empty)[0]).reshape(I_single.shape)
    torch.cuda.synchronize()
    n = launch_counts()
    I_m = I_m.cpu().numpy()
    print(f"mesh table forward vs single-device: max |err| "
          f"{float(np.abs(I_m - I_single).max()):.3e} of max "
          f"{float(np.abs(I_single).max()):.3e}; launches {json.dumps(n)}")
    expect_launches("the mesh table forward", n)
    np.testing.assert_allclose(I_m, I_single, rtol=MESH_RTOL,
                               atol=MESH_RTOL * np.abs(I_single).max())
    prob = cli.retrieval_problem(cfg, scene, KERNELS)
    oe = cli.sharded_problem(cfg, scene, mesh, prob.atm, prob.init(prob.atm))
    y_obs, sigma = t["obs"]
    oe.bind_observation(y_obs, sigma)
    reset_launches()
    F, H, g = oe.normal_eqs(prob.x0)
    torch.cuda.synchronize()
    n = launch_counts()
    J64 = t["jac"](prob.x0).double().cpu().numpy()
    w = 1.0 / sigma.astype(np.float64) ** 2
    y0 = prob.fwd_flat(prob.x0).double().cpu().numpy()
    H_ref = (J64.T * w) @ J64
    g_ref = (J64.T * w) @ (y_obs.astype(np.float64) - y0)
    errs = {"F": float(np.abs(F.double().cpu().numpy() - y0).max()
                       / np.abs(y0).max()),
            "H": float(np.abs(H.cpu().numpy() - H_ref).max()
                       / np.abs(H_ref).max()),
            "g": float(np.abs(g.cpu().numpy() - g_ref).max()
                       / np.abs(g_ref).max())}
    print(f"sharded table normal equations vs the single-device table "
          f"Jacobian: max |err| / max |ref| {json.dumps(errs)}; launches "
          f"{json.dumps(n)}")
    expect_launches("the sharded table normal equations", n)
    check(all(v <= MESH_RTOL for v in errs.values()),
          "the sharded table normal equations disagree with one device's")

    # The 2-D climatology at 45 deg N: forward and retrieve through the
    # line sums (K1, K2) and through its table.
    zonal = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, ov in (("direct", ZONAL_CLI),
                         ("table", {**ZONAL_CLI, **LUT_CLI})):
            res, n_f, _ = cli_run("forward", ov, tmp)
            zonal[name] = I = res["values"]
            res, n_r, iters = cli_run("retrieve", ov, tmp)
            n_iter = int(res["n_iter"])
            print(f"mars_zonal at 45 N, {name}: forward {I.shape}, max "
                  f"{I.max():.4e}, launches {json.dumps(n_f)}; retrieve "
                  f"converged {bool(res['converged'])}, chi2 "
                  f"{iters[0]['chi2']:.6g} -> {float(res['chi2']):.6g}, "
                  f"{n_iter} LM iterations, launches {json.dumps(n_r)}")
            expect_launches(f"the 2-D {name} CLI forward", n_f, K1=1)
            check(bool(np.isfinite(I).all() and (I >= 0).all()),
                  f"2-D {name} radiances not finite and non-negative")
            check(bool(res["converged"]), f"the 2-D {name} retrieval did "
                                          f"not converge")
            if name == "direct":
                check(n_r["K1"] > 0 and n_r["K2"] == n_iter + 1,
                      "the 2-D retrieve did not run K1 and one K2 per "
                      "Jacobian")
            else:
                expect_launches("the 2-D table CLI retrieve", n_r, K1=1)
    rel = lut_rel(zonal["table"], zonal["direct"])
    print(f"mars_zonal at 45 N: table vs direct forward {rel:.4f}; vs the "
          f"1-D mars_standard forward max |diff| "
          f"{float(np.abs(zonal['direct'] - direct['LTE']['I']).max()):.3e}")
    check(rel < LUT_REL, "the 2-D table forward is off the direct one")
    return out


# Phase 6h: the Weideman evaluator (compute.variant = "weideman": plain
# PyTorch on the card, in float64; no kernel evaluates it, as no Pallas
# kernel does in the reference), run.save_optics and the profiling
# utilities.
WEIDEMAN_CLI = {"compute.variant": "weideman", "compute.dtype": "float64"}
# Config 1 through Weideman in float64 against the float64 oracle: the
# reference's golden budget for that evaluator
# (tests/test_config1_golden.py:40).
WEIDEMAN_ORACLE_RTOL = 5e-4
# Weideman in float64 against Humlicek w4 through the kernels in float32,
# radiances and Jacobians: max |diff| <= WEIDEMAN_GAP max |Weideman|.  The
# gap is the two approximants' (w4 is good to about 1e-4 relative of w,
# tests/test_voigt.py) and the kernels' float32 roundoff: 5.0e-5 of the
# radiances and 6.3e-5 of the Jacobian on an H100 (PERF.md section 6).
WEIDEMAN_GAP = 2e-4
# The float64 reverse gradient against J^T dL/dy from the float64
# Jacobian: |err| <= WEIDEMAN_GRAD_REL x the largest sum of absolute terms
# sum_i |J_ij r_i / sigma_i^2| (the terms cancel at the prior).
WEIDEMAN_GRAD_REL = 1e-9
# optics.npz's keys as the reference writes them
# (spectrobot_tpu/cli.py:459-474 through Spectrum.save_npz).
OPTICS_KEYS = ["kind", "nu", "transmittance", "units", "values"]


def weideman_phase(dev, cfg, scene, I, J, card: str) -> dict:
    """Phase 6h on the card: config 1, the CLI forward, the Jacobian, the
    CLI retrieve and the reverse gradient with compute.variant =
    "weideman" in float64 (no kernel launch); run.save_optics on the
    humlicek4 CLI forward (one K1 launch); ``utils.profiling.trace``
    around one forward.  ``I``: phase 5's CLI radiances and ``J`` phase
    6's Jacobian, both through the kernels.  Prints each sub-phase's wall
    time [ms] beside ``card`` and the float64 peak memories; returns the
    Jacobian's (peak, resident) memory [GB]."""
    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch.forward.model import nadir_single_layer
    from spectrobot_tpu_torch.ops.cuda_basis import KERNELS, PLAIN, WEIDEMAN
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist
    from spectrobot_tpu_torch.utils.profiling import annotate, trace

    f64 = torch.float64
    walls = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = 1e3 * (time.perf_counter() - t0)
        print(f"time 6h {name} [{card}]: {walls[name]:.1f} ms")
        return out

    # (a) Config 1 in float64 against the oracle, no kernel launch.
    ll, _, nu = config1_scene(dev)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=f64, device=dev)
    nu = nu.to(f64)
    x = [torch.tensor(v, dtype=f64, device=dev) for v in CONFIG1.values()]
    reset_launches()
    I1 = timed("(a) config 1", lambda: nadir_single_layer(
        nu, dl, *x, variant="weideman").cpu().numpy())
    expect_launches("config 1 with Weideman", launch_counts())
    oracle = config1_oracle(ll, np.linspace(630.0, 705.0, 3001))
    rel = float(np.max(np.abs(I1 - oracle) / np.abs(oracle)))
    print(f"6h (a) config 1, Weideman float64 vs the float64 oracle: max "
          f"rel err {rel:.3e} (budget {WEIDEMAN_ORACLE_RTOL:g})")
    check(rel <= WEIDEMAN_ORACLE_RTOL,
          "config 1 with Weideman misses the oracle's budget")

    # (b) The CLI forward, against phase 5's kernel radiances.
    with tempfile.TemporaryDirectory() as tmp:
        res, n, _ = timed("(b) CLI forward", lambda: cli_run(
            "forward", WEIDEMAN_CLI, tmp))
    expect_launches("the Weideman CLI forward", n)
    I_w = res["values"]
    check(I_w.shape == I.shape and I_w.dtype == np.float64
          and bool(np.isfinite(I_w).all()),
          f"Weideman radiances {I_w.shape} {I_w.dtype} not finite float64 "
          f"of shape {I.shape}")
    gap = float(np.abs(I_w - I).max() / np.abs(I_w).max())
    print(f"6h (b) CLI forward, Weideman float64 vs humlicek4 K1 float32: "
          f"max |diff| {gap:.3e} of max radiance (budget {WEIDEMAN_GAP:g})")
    check(gap <= WEIDEMAN_GAP, "the Weideman forward is off the kernels'")

    # (c) The Jacobian at the prior, and the CLI retrieve.
    cfg_w = cli.load_config(SCENE, WEIDEMAN_CLI)
    scene_w = cli.build_scene(cfg_w, dev)
    check(cli.select_engine(cfg_w, dev) is WEIDEMAN,
          "compute.variant = weideman did not select the WEIDEMAN engine")
    prob = cli.retrieval_problem(cfg_w, scene_w, WEIDEMAN)
    jac = cli.make_jacobian(cfg_w, prob.fwd_flat, int(prob.x0.shape[0]),
                            int(scene_w.nu.shape[0]), dev)
    out = []
    reset_launches()
    peak = timed("(c) Jacobian", lambda: peak_memory(
        lambda: out.append(jac(prob.x0))))
    expect_launches("the Weideman Jacobian", launch_counts())
    J_w = out.pop()
    jgap = float((J_w - J.to(f64)).abs().max() / J_w.abs().max())
    print(f"6h (c) Jacobian {tuple(J_w.shape)} float64 Weideman vs "
          f"humlicek4 K1 + K2 float32: max |diff| {jgap:.3e} of max |K| "
          f"(budget {WEIDEMAN_GAP:g}); peak device memory {peak[0]:.2f} GB "
          f"({peak[1]:.2f} GB resident before it)")
    check(bool(torch.isfinite(J_w).all()), "non-finite Weideman Jacobian")
    check(jgap <= WEIDEMAN_GAP, "the Weideman Jacobian is off the kernels'")
    with tempfile.TemporaryDirectory() as tmp:
        res, n, iters = timed("(c) CLI retrieve", lambda: cli_run(
            "retrieve", {**WEIDEMAN_CLI, "retrieval.max_iter": "2"}, tmp))
    expect_launches("the Weideman CLI retrieve", n)
    chi2 = float(res["chi2"])
    print(f"6h (c) CLI retrieve (max_iter 2): chi2 {iters[0]['chi2']:.6g} "
          f"at the prior -> {chi2:.6g} after {int(res['n_iter'])} LM "
          f"iterations ({res['stop_reason']})")
    check(np.isfinite(chi2) and chi2 < iters[0]["chi2"],
          "the Weideman retrieval's chi2 did not fall below the prior's")

    # (d) The reverse gradient of the retrieval cost, against J^T dL/dy.
    y_obs = torch.as_tensor(res["y_obs"].reshape(-1), dtype=f64, device=dev)
    sig = torch.as_tensor(res["noise"].reshape(-1), dtype=f64, device=dev)
    rev = cli.retrieval_problem(cfg_w, scene_w, WEIDEMAN, analytic_jvp="rev")

    def grad():
        x = rev.x0.detach().clone().requires_grad_()
        r = (rev.fwd_flat(x) - y_obs) / sig
        return torch.autograd.grad(0.5 * torch.sum(r * r), x)[0]

    reset_launches()
    g = timed("(d) reverse gradient", grad)
    expect_launches("the Weideman reverse gradient", launch_counts())
    w = (prob.fwd_flat(prob.x0) - y_obs) / sig ** 2
    g_jac = J_w.T @ w
    scale = float((J_w.abs().T @ w.abs()).max())
    gerr = float((g - g_jac).abs().max())
    print(f"6h (d) reverse gradient vs J^T dL/dy (float64): max |err| "
          f"{gerr:.3e}, {gerr / scale:.3e} of the largest absolute sum "
          f"{scale:.3e} (budget {WEIDEMAN_GRAD_REL:g})")
    check(gerr <= WEIDEMAN_GRAD_REL * scale,
          "the Weideman reverse gradient disagrees with J^T dL/dy")

    # (e) run.save_optics on the humlicek4 CLI forward: the same K1 call.
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        timed("(e) CLI forward with save_optics", lambda: cli.main([
            "forward", SCENE, "-o", "run.save_optics=true", "-o",
            f"run.output_dir={tmp}", "--device", "cuda"]))
        n = launch_counts()
        with np.load(os.path.join(tmp, "optics.npz")) as f:
            optics = {k: f[k] for k in f.files}
    expect_launches("the CLI forward with run.save_optics", n, K1=1)
    check(sorted(optics) == OPTICS_KEYS,
          f"optics.npz keys {sorted(optics)} != {OPTICS_KEYS}")
    check(str(optics["kind"]) == "optical_depth", "optics.npz kind")
    tau = optics["values"]
    check(np.array_equal(optics["transmittance"], np.exp(-tau)),
          "optics.npz transmittance != exp(-values)")
    taps = []
    cli.run_forward(cfg, scene, PLAIN,
                    depths_tap=lambda cg, d: taps.append((cg, d)))
    cg, d = taps[0]
    tau_plain = d[:, cg.seg_layer, :].sum(dim=1).cpu().numpy()
    err = np.abs(tau - tau_plain)
    ok = bool(np.all(err <= RTOL * np.abs(tau_plain)
                     + ATOL_REL * np.abs(tau_plain).max()))
    print(f"6h (e) save_optics: K1 launches {n['K1']}; LOS depth "
          f"{tau.shape} vs the plain engine's max |err| {err.max():.3e} of "
          f"max {np.abs(tau_plain).max():.3e} (K1 budget): "
          f"{'ok' if ok else 'FAILED'}")
    check(ok, "the save_optics depths disagree with the plain engine's")

    # (f) utils.profiling.trace around one forward: up to three traces, as
    # torch.profiler may record none of a window's ctypes launches
    # (device_kernels).
    cli.run_forward(cfg, scene, KERNELS)
    with tempfile.TemporaryDirectory() as tmp:
        for tries in range(1, 4):
            reset_launches()
            with trace(tmp):
                with annotate("chip_smoke_forward"):
                    cli.run_forward(cfg, scene, KERNELS)
            n = launch_counts()
            with open(os.path.join(tmp, "trace.json")) as f:
                text = f.read()
            found = {k: k in text for k in ("chip_smoke_forward",
                                            "opacity_batch_kernel")}
            if all(found.values()):
                break
    print(f"6h (f) torch.profiler trace of one forward ({len(text)} bytes, "
          f"trace {tries} of at most 3): {json.dumps(found)}; launches "
          f"{json.dumps(n)}")
    check(all(found.values()), f"the trace lacks {found}")
    expect_launches("the traced forward", n, K1=1)
    fwd_peak = peak_memory(lambda: cli.run_forward(cfg_w, scene_w, WEIDEMAN))
    print(f"6h peak device memory of one Weideman forward: {fwd_peak[0]:.2f}"
          f" GB ({fwd_peak[1]:.2f} GB resident before it; the plain slabs "
          f"of 2^25 pairs in float64)")
    walls["warm Weideman forward"] = wall_ms(
        lambda: cli.run_forward(cfg_w, scene_w, WEIDEMAN), n=2)
    print(f"time 6h warm Weideman forward [{card}]: "
          f"{walls['warm Weideman forward']:.1f} ms (float64, "
          f"examples/mars_limb.toml, cli.run_forward, median of 2 after a "
          f"warm-up)")
    return {"jac_peak": peak}


# Phase 6k: K2 past its row limit, acceptance config 5 and the Jacobian's
# memory guard.  K2's row-group cases on the slice's states (two groups of
# 114, three of 150).
K2_GROUP_ROWS = (228, 450)
CONFIG5 = os.path.join(REPO, "examples", "multispecies_retrieval.toml")
# Config 5 at 38 levels retrieving both species: n_x = 38 + 2 x 38 = 114,
# so its unchunked Jacobian gives K2 R = 228 rows (two groups).
CONFIG5_WIDE = {"scene.n_levels": "38", "retrieval.retrieve_vmr": "CO2,CO"}
# The guard's counted bytes over the measured increase of a Jacobian's
# peak memory (peak - resident) must lie in this range.
GUARD_RATIO = (0.8, 2.0)
# The same for a Jacobian whose epilogue is the fused kernel: its count,
# cli.JAC_LIVE_TANGENTS, is the composed epilogue's (kept until it is
# measured again), 2.26-3.39 times what those Jacobians hold (NVIDIA H100
# 80GB HBM3 at 700 W; the composed scene lowest, its CIA adding to both
# depths).  Both ends hold: a new temporary or copy of a tangent's size
# still falls below the lower end in the composed scene, a larger one in
# every scene.
FUSED_GUARD_RATIO = (2.0, 4.0)


def k2_rows_phase(cases: dict, card: str) -> None:
    """Phase 6k (a): K2 at ``K2_GROUP_ROWS`` rows on the slice's states
    against its plain version (K2_REL), one launch a row group; its time
    (CUDA events) beside the bound of the same work and beside one
    launch of one group's rows."""
    from spectrobot_tpu_torch.ops import cuda_basis as cb

    t0 = time.perf_counter()
    case = cases["limb"]
    B, L, P = case.nu_c.shape[0], case.nu_c.shape[1], case.nu.shape[0]
    live = case.amps.flatten(1).ne(0).any(1)
    pairs = case_region_counts(case, live)
    for seed, R in enumerate(K2_GROUP_ROWS, 300):
        C = coefficient_rows(case, R // 2, seed)
        reset_launches()
        compare_k2(case, C)
        n = launch_counts()["K2"]
        groups = cb.row_spans(R)
        check(n == len(groups), f"K2 at R = {R} launched {n} times, not "
                                f"once for each of its {len(groups)} row "
                                f"groups")
        call = lambda C: lambda: cb.basis_contract_batch(
            case.nu, case.windows, case.nu_c, case.sx, case.y, *C,
            chi_b=case.chi_b)
        ms = cuda_ms(call(C))
        # One group's rows in one launch: the split costs each group's
        # launch (the basis evaluated again) and the copy of its rows into
        # the output.
        G = groups[0][1]
        ms_group = cuda_ms(call([c[:, :G].contiguous() for c in C]))
        bound = basis_bound_ms(pairs, R, basis_batch_bytes(B, L, P, R))
        print(f"K2 at R = {R} [{card}]: {len(groups)} row groups "
              f"{[b - a for a, b in groups]}, {n} launches; {ms:.3f} ms "
              f"(CUDA events, median of 5; one launch of {G} rows "
              f"{ms_group:.3f} ms) vs bound {bound[0]:.4f} ms "
              f"({bound[2]}); {B} states x {L} lines x {P} points")
        del C
    print(f"time 6k (a) K2 row groups [{card}]: "
          f"{time.perf_counter() - t0:.1f} s")


def config5_phase(dev, card: str) -> dict:
    """Phase 6k (b): acceptance config 5 (examples/multispecies_retrieval
    .toml, CO2 + CO limb) through the kernels: the CLI forward (one K1),
    the Jacobian at the prior against the plain engine's (K2_REL), the CLI
    retrieve with retrieval.max_iter = 2 (chi2 below the prior's); then at
    38 levels retrieving both species (n_x = 114): the unchunked Jacobian
    (one K1, K2 in two row groups) against the plain engine's.  Returns
    each Jacobian's (cfg, n_x, (peak, resident) memory)."""
    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch.ops.cuda_basis import KERNELS, PLAIN, row_spans

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        cli.main(["forward", CONFIG5, "-o", f"run.output_dir={tmp}",
                  "--device", "cuda"])
        n = launch_counts()
        with np.load(os.path.join(tmp, "forward.npz")) as f:
            I5 = f["values"]
    print(f"config 5 CLI forward: {I5.shape}, max {I5.max():.4e}; launches "
          f"{json.dumps(n)}")
    expect_launches("the config 5 CLI forward", n, K1=1)
    check(bool(np.isfinite(I5).all() and (I5 >= 0).all()),
          "config 5 radiances not finite and non-negative")
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        cli.main(["retrieve", CONFIG5, "-o", "retrieval.max_iter=2", "-o",
                  f"run.output_dir={tmp}", "--device", "cuda"])
        n = launch_counts()
        with np.load(os.path.join(tmp, "retrieval.npz")) as f:
            res = {k: f[k] for k in f.files}
        with open(os.path.join(tmp, "run.jsonl")) as f:
            iters = [r for r in map(json.loads, f) if "chi2" in r]
    chi2 = float(res["chi2"])
    print(f"config 5 CLI retrieve (max_iter 2): {res['x'].size} parameters, "
          f"chi2 {iters[0]['chi2']:.6g} at the prior -> {chi2:.6g} after "
          f"{int(res['n_iter'])} LM iterations ({res['stop_reason']}); "
          f"launches {json.dumps(n)}")
    check(res["x"].size == 50, f"config 5 retrieves {res['x'].size} "
                               f"parameters, not 50")
    check(n["K1"] > 0 and n["K2"] >= int(res["n_iter"]) and n["K5"] == 0,
          "the config 5 retrieve did not run K1 and K2 (one a Jacobian)")
    check(np.isfinite(chi2) and chi2 < iters[0]["chi2"],
          "the config 5 retrieval's chi2 did not fall")
    for name, ov in (("config 5", {}), ("config 5, 38 levels, CO2 + CO",
                                        CONFIG5_WIDE)):
        cfg = cli.load_config(CONFIG5, ov)
        scene = cli.build_scene(cfg, dev)
        prob = {e.name: cli.retrieval_problem(cfg, scene, e)
                for e in (KERNELS, PLAIN)}
        x0 = prob["kernels"].x0
        n_x, n_fine = int(x0.shape[0]), int(scene.nu.shape[0])
        chunk = cli.jacobian_chunk(cfg, n_x, n_fine, dev)
        jac = {k: cli.make_jacobian(cfg, p.fwd_flat, n_x, n_fine, dev)
               for k, p in prob.items()}
        got = []
        reset_launches()
        peak = peak_memory(lambda: got.append(jac["kernels"](x0)))
        n = launch_counts()
        J = got.pop()
        J_plain = jac["plain"](x0)
        err = float((J - J_plain).abs().max())
        scale = float(J_plain.abs().max())
        print(f"{name} Jacobian {tuple(J.shape)} (n_x {n_x}, chunk "
              f"{chunk}): kernels vs plain max |err| {err:.3e} of max |K| "
              f"{scale:.3e} ({err / scale:.3e}); peak device memory "
              f"{peak[0]:.2f} GB ({peak[1]:.2f} GB resident before it); "
              f"launches {json.dumps(n)}")
        check(chunk is None, f"{name}: the guard chunked the Jacobian")
        expect_launches(f"the {name} Jacobian", n, K1=1,
                        K2=len(row_spans(2 * n_x)))
        check(bool(torch.isfinite(J).all()), f"{name}: non-finite Jacobian")
        check(err <= K2_REL * scale, f"{name}: the kernel Jacobian "
                                     f"disagrees with the plain one")
        out[name] = (cfg, n_x, peak)
        del J, J_plain, got
    check(out["config 5, 38 levels, CO2 + CO"][1] == 114,
          "config 5 at 38 levels with CO2 and CO is not n_x = 114")
    print(f"time 6k (b) config 5 [{card}]: "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def guard_phase(dev, card: str, scenes: dict, extra: dict) -> None:
    """Phase 6k (c): the Jacobian's memory guard against this run's peaks.
    ``scenes``: name -> (cfg, n_x, (peak, resident) GB) of the slice,
    config 3, the composed scene and the float64 Weideman slice, each
    unchunked, whose counted bytes (``cli.jacobian_bytes``) must lie
    within GUARD_RATIO of the measured increase (peak - resident);
    ``extra``: more such Jacobians, printed beside them."""
    from spectrobot_tpu_torch import cli

    limit = cli.jacobian_limit(dev)
    print(f"6k (c) Jacobian guard [{card}]: limit {limit / 1e9:.2f} GB, "
          f"{cli.JAC_LIVE_TANGENTS:g} live tangents counted")
    for name, (cfg, n_x, peak) in {**scenes, **extra}.items():
        n_fine = cfg.grid.n_points
        counted = cli.jacobian_bytes(cfg, n_x, n_fine)
        grown = (peak[0] - peak[1]) * 1e9
        ratio = counted / grown
        chunk = cli.jacobian_chunk(cfg, n_x, n_fine, dev)
        route = peak[2]
        bounds = FUSED_GUARD_RATIO if route == "fused" else GUARD_RATIO
        print(f"6k (c) {name}: counted {counted / 1e9:.2f} GB, measured "
              f"increase {grown / 1e9:.2f} GB (peak {peak[0]:.2f} - "
              f"resident {peak[1]:.2f}), ratio {ratio:.3f}; chunk {chunk}; "
              f"epilogue {route}")
        want = ("fused" if cli.select_engine(cfg, dev) is cli.KERNELS
                else "composed")
        check(route == want, f"{name}: the Jacobian's epilogue took the "
                             f"{route} route, not the {want} one")
        if name in scenes or route == "fused":
            check(bounds[0] <= ratio <= bounds[1],
                  f"{name}: the guard counts {ratio:.3f} x the measured "
                  f"increase, outside {bounds} ({route} epilogue)")
        if name in scenes:
            check(chunk is None, f"{name}: the guard chunks the Jacobian")


# Phase 6l: the engine rule's two other humlicek4 configurations at full
# width: compute.dtype = "float64" through the float32 kernels (KERNELS
# casts a float64 pipeline's inputs and results), and compute.use_pallas
# = false through the plain engine (PLAIN, in the configured dtype).
F64_CLI = {"compute.dtype": "float64"}
NO_PALLAS_CLI = {"compute.use_pallas": "false"}
# The float64 reverse gradient against J^T dL/dy from the float64
# Jacobian (both through the float32 kernels), and against the float32-cast
# plain engine's: max |err| <= F64_GRAD_REL max |ref|.
F64_GRAD_REL = 1e-5


def cast_plain_engine():
    """The plain versions computing in float32 on the card, as KERNELS
    does: what a float64 run through the kernels is held to."""
    from spectrobot_tpu_torch.ops.cuda_basis import PLAIN
    from spectrobot_tpu_torch.ops.opacity import with_compute_dtype
    return with_compute_dtype(dataclasses.replace(PLAIN, name="cast plain"),
                              torch.float32)


def sum_error(got, ref) -> tuple:
    """(max |err|, the worst ratio to K1's budget) of ``got`` against
    ``ref`` (tensors or arrays), in float64."""
    got, ref = (torch.as_tensor(a).double().cpu() for a in (got, ref))
    err = (got - ref).abs()
    return float(err.max()), float(
        (err / (RTOL * ref.abs() + ATOL_REL * ref.abs().max())).max())


def rel_max(got, ref) -> float:
    """max |got - ref| / max |ref|, in float64."""
    got, ref = (torch.as_tensor(a).double().cpu() for a in (got, ref))
    return float((got - ref).abs().max() / ref.abs().max())


def engine_dtype_phase(dev, mesh, cfg, scene, I, J, card: str) -> dict:
    """Phase 6l on the card: examples/mars_limb.toml with compute.dtype =
    "float64" through the kernels (the CLI forward, the Jacobian and its
    peak against ``cli.jacobian_bytes``, the CLI retrieve, the reverse
    gradient), config 3's forward and Jacobian, config 1 (K3, K4), the LTE
    table build and the (1, 1, 1) mesh forward in both tiers (graphed and
    eager), each float64 with the float32 path's launches and within the
    float32 budgets of the same engine over the plain versions in float32;
    the slice's distance from the pure float64 plain engine; then
    compute.use_pallas = false in float32 and float64 (forward and
    Jacobian, no kernel launch).  ``I``, ``J``: phase 5's and 6's float32
    radiances and Jacobian.  Prints each wall beside ``card`` and the
    float32 one; returns the walls [ms]."""
    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch import halo_overlap as ho
    from spectrobot_tpu_torch.forward.model import nadir_single_layer
    from spectrobot_tpu_torch.ops import lut
    from spectrobot_tpu_torch.ops.cuda_basis import KERNELS, PLAIN
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist
    from spectrobot_tpu_torch.parallel import graphed
    from spectrobot_tpu_torch.retrieval.state import flatten_state, make_state

    f64 = torch.float64
    cast = cast_plain_engine()
    t_phase = time.perf_counter()
    walls = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls[name] = 1e3 * (time.perf_counter() - t0)
        return res

    def counted(fn):
        reset_launches()
        res = fn()
        torch.cuda.synchronize()
        return res, launch_counts()

    # (a) The engine rule on the card.
    for ov, want in (({}, KERNELS), (F64_CLI, KERNELS),
                     (NO_PALLAS_CLI, PLAIN),
                     ({**F64_CLI, **NO_PALLAS_CLI}, PLAIN)):
        c = cli.load_config(SCENE, ov)
        e = cli.select_engine(c, dev)
        dt = f64 if c.compute.dtype == "float64" else torch.float32
        print(f"6l (a) engine for {json.dumps(ov)}: {e.describe(dt, dev)}")
        check(e is want, f"{json.dumps(ov)} selected {e.name}, not "
                         f"{want.name}")

    # (b) The CLI forward in float64 through the kernels, against the
    # float32-cast plain engine and the pure float64 plain engine (the CLI
    # with compute.use_pallas = false).
    cfg64 = cli.load_config(SCENE, F64_CLI)
    scene64 = cli.build_scene(cfg64, dev)
    with tempfile.TemporaryDirectory() as tmp:
        res, n, _ = timed("(b) CLI forward", lambda: cli_run(
            "forward", F64_CLI, tmp))
        I64, chans = res["values"], res["nu"]
        res, n_pure, _ = cli_run("forward", {**F64_CLI, **NO_PALLAS_CLI},
                                 tmp)
        I_pure = res["values"]
    expect_launches("the float64 CLI forward", n, K1=1)
    expect_launches("the float64 CLI forward with use_pallas = false",
                    n_pure)
    I_dev = cli.run_forward(cfg64, scene64, KERNELS)
    check(I_dev.dtype == f64 and I64.shape == I.shape
          and np.array_equal(I_dev.cpu().numpy(), I64)
          and bool(np.isfinite(I64).all() and (I64 >= 0).all()),
          f"float64 radiances {I64.shape} ({I_dev.dtype} on the card) not "
          f"the finite, non-negative float64 of shape {I.shape} the CLI "
          f"wrote")
    I_cast = cli.run_forward(cfg64, scene64, cast)
    err, worst = sum_error(I64, I_cast)
    print(f"6l (b) CLI forward float64 through the kernels: launches "
          f"{json.dumps(n)}; vs the float32-cast plain engine max |err| "
          f"{err:.3e}, {worst:.3e} x K1's budget; vs pure float64 plain "
          f"{rel_max(I64, I_pure):.3e} of max radiance; vs the float32 CLI "
          f"forward {rel_max(I64, I):.3e}")
    check(worst <= 1.0, "the float64 forward disagrees with the float32-"
                        "cast plain engine")
    band = np.trapezoid(I64, chans, axis=1)
    check(bool(np.all(np.diff(band) < 0)),
          "the float64 band radiance does not fall with tangent height")

    # (c) The Jacobian at the prior: through the kernels (one K1, one K2;
    # its peak against the guard's count), the float32-cast plain engine
    # and the pure float64 plain engine (compute.use_pallas = false).
    cfg_pure = cli.load_config(SCENE, {**F64_CLI, **NO_PALLAS_CLI})
    jacs, probs = {}, {}
    for name, c, e in (("kernels", cfg64, KERNELS), ("cast", cfg64, cast),
                       ("pure", cfg_pure, cli.select_engine(cfg_pure, dev))):
        p = probs[name] = cli.retrieval_problem(c, scene64, e)
        n_x, n_fine = int(p.x0.shape[0]), int(scene64.nu.shape[0])
        check(cli.jacobian_chunk(c, n_x, n_fine, dev) is None,
              f"the float64 Jacobian ({name}) is chunked")
        jac = cli.make_jacobian(c, p.fwd_flat, n_x, n_fine, dev)
        got = []
        reset_launches()
        peak = timed(f"(c) Jacobian, {name}", lambda: peak_memory(
            lambda: got.append(jac(p.x0))))
        jacs[name] = (got.pop(), launch_counts(), peak, jac)
    J64, n, peak, jac64 = jacs["kernels"]
    expect_launches("the float64 Jacobian", n, K1=1, K2=1, epilogue=2)
    expect_launches("the pure float64 plain Jacobian", jacs["pure"][1])
    check(J64.dtype == f64 and bool(torch.isfinite(J64).all()),
          "the float64 Jacobian is not finite float64")
    jerr = rel_max(J64, jacs["cast"][0])
    counted_b = cli.jacobian_bytes(cfg64, n_x, n_fine)
    grown = (peak[0] - peak[1]) * 1e9
    print(f"6l (c) Jacobian {tuple(J64.shape)} float64 through the kernels: "
          f"launches {json.dumps(n)}; vs the float32-cast plain engine "
          f"{jerr:.3e} of max |K| (budget {K2_REL:g}); vs pure float64 "
          f"plain {rel_max(J64, jacs['pure'][0]):.3e}; vs the float32 "
          f"Jacobian {rel_max(J64, J):.3e}")
    print(f"6l (c) float64 Jacobian peak device memory {peak[0]:.2f} GB "
          f"({peak[1]:.2f} GB resident before it): increase "
          f"{grown / 1e9:.2f} GB against cli.jacobian_bytes "
          f"{counted_b / 1e9:.2f} GB, ratio {counted_b / grown:.3f} "
          f"({cli.JAC_LIVE_TANGENTS:g} float64 tangents counted); pure "
          f"float64 plain {jacs['pure'][2][0]:.2f} GB, float32-cast plain "
          f"{jacs['cast'][2][0]:.2f} GB")
    check(jerr <= K2_REL, "the float64 Jacobian disagrees with the "
                          "float32-cast plain engine's")
    check(peak[2] == "fused", f"the float64 Jacobian's epilogue took the "
                              f"{peak[2]} route, not the fused one")
    check(FUSED_GUARD_RATIO[0] <= counted_b / grown <= FUSED_GUARD_RATIO[1],
          f"the guard counts {counted_b / grown:.3f} x the float64 "
          f"Jacobian's increase, outside {FUSED_GUARD_RATIO} (fused "
          f"epilogue)")

    # (d) The CLI retrieve in float64: K1 and K2 as in float32.
    with tempfile.TemporaryDirectory() as tmp:
        res, n, iters = timed("(d) CLI retrieve", lambda: cli_run(
            "retrieve", F64_CLI, tmp))
    n_iter, chi2 = int(res["n_iter"]), float(res["chi2"])
    print(f"6l (d) CLI retrieve float64: converged {bool(res['converged'])} "
          f"({res['stop_reason']}), chi2 {iters[0]['chi2']:.6g} at the "
          f"prior -> {chi2:.6g} in {n_iter} LM iterations; launches "
          f"{json.dumps(n)}")
    check(n["K1"] > 0 and n["K2"] == n_iter + 1 and n["K5"] == 0,
          f"the float64 retrieve launched {json.dumps(n)} for {n_iter} LM "
          f"iterations")
    check(bool(res["converged"]) and chi2 < iters[0]["chi2"],
          "the float64 retrieval did not converge")
    check(res["y_fit"].dtype == np.float64, "the float64 fit is not float64")

    # (e) The reverse gradient of the retrieval cost: one K1, one K5.
    y_obs = torch.as_tensor(res["y_obs"].reshape(-1), dtype=f64, device=dev)
    sig = torch.as_tensor(res["noise"].reshape(-1), dtype=f64, device=dev)

    def cost_grad(p, y_o, s):
        x = p.x0.detach().clone().requires_grad_()
        r = (p.fwd_flat(x) - y_o) / s
        return torch.autograd.grad(0.5 * torch.sum(r * r), x)[0]

    rev = {e.name: cli.retrieval_problem(cfg64, scene64, e,
                                         analytic_jvp="rev")
           for e in (KERNELS, cast)}
    g, n = counted(lambda: timed("(e) reverse gradient", lambda: cost_grad(
        rev["kernels"], y_obs, sig)))
    expect_launches("the float64 reverse gradient", n, K1=1, K5=1)
    g_jac = J64.T @ ((probs["kernels"].fwd_flat(probs["kernels"].x0) - y_obs)
                     / sig ** 2)
    g_cast = cost_grad(rev["cast plain"], y_obs, sig)
    gerr = {"J^T dL/dy": rel_max(g, g_jac), "cast plain": rel_max(g, g_cast)}
    print(f"6l (e) reverse gradient float64 ({g.dtype}): launches "
          f"{json.dumps(n)}; max |err| / max |ref| {json.dumps(gerr)} "
          f"(budget {F64_GRAD_REL:g})")
    check(g.dtype == f64 and all(v <= F64_GRAD_REL for v in gerr.values()),
          "the float64 reverse gradient disagrees")

    # (f) Config 3 in float64: forward (one K1) and Jacobian (one K1, one
    # K2) against the float32-cast plain engine.
    cfg3 = cli.load_config(SCENE, {**CONFIG3_CLI, **F64_CLI})
    scene3 = cli.build_scene(cfg3, dev)
    I3, n = counted(lambda: cli.run_forward(cfg3, scene3, KERNELS))
    expect_launches("the float64 config 3 forward", n, K1=1)
    err, worst = sum_error(I3, cli.run_forward(cfg3, scene3, cast))
    p3 = {e.name: cli.retrieval_problem(cfg3, scene3, e)
          for e in (KERNELS, cast)}
    J3 = {}
    for name, p in p3.items():
        reset_launches()
        J3[name] = cli.make_jacobian(cfg3, p.fwd_flat, int(p.x0.shape[0]),
                                     int(scene3.nu.shape[0]), dev)(p.x0)
        torch.cuda.synchronize()
        if name == "kernels":
            n3 = launch_counts()
    j3err = rel_max(J3["kernels"], J3["cast plain"])
    print(f"6l (f) config 3 float64: forward {I3.dtype} vs the float32-cast "
          f"plain engine max |err| {err:.3e}, {worst:.3e} x K1's budget "
          f"(launches {json.dumps(n)}); Jacobian "
          f"{tuple(J3['kernels'].shape)} {j3err:.3e} of max |K| (launches "
          f"{json.dumps(n3)})")
    expect_launches("the float64 config 3 Jacobian", n3, K1=1, K2=1)
    check(I3.dtype == f64 and J3["kernels"].dtype == f64,
          "config 3 in float64 is not float64")
    check(worst <= 1.0 and j3err <= K2_REL,
          "config 3 in float64 disagrees with the float32-cast plain engine")

    # (g) Config 1 in float64: one K3; its Jacobian one K3 and one K4.
    ll, dl32, nu32 = config1_scene(dev)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=f64, device=dev)
    nu = nu32.to(f64)
    x = [torch.tensor(v, dtype=f64, device=dev) for v in CONFIG1.values()]
    rad = lambda engine: (lambda *a: nadir_single_layer(nu, dl, *a,
                                                        engine=engine))
    I1, n = counted(lambda: rad(None)(*x))
    expect_launches("the float64 config-1 radiance", n, K3=1)
    golden = config1_oracle(ll, np.linspace(630.0, 705.0, 3001))
    err_gold = np.abs(I1.cpu().numpy() - golden)
    worst = float((err_gold / (ORACLE_RTOL * np.abs(golden) + ORACLE_ATOL_REL
                               * np.abs(golden).max())).max())
    argn = tuple(range(len(x)))
    J1, n = counted(lambda: torch.func.jacfwd(rad(None), argnums=argn)(*x))
    expect_launches("the float64 config-1 Jacobian", n, K3=1, K4=1)
    ratio = column_errors(J1, torch.func.jacfwd(rad(cast), argnums=argn)(*x))
    print(f"6l (g) config 1 float64: radiance {I1.dtype} vs the float64 "
          f"oracle {worst:.3e} x its float32 budget; Jacobian worst column "
          f"{ratio:.3e} x {K2_REL:g} of the float32-cast plain engine's; "
          f"launches K3 1, K4 1")
    check(I1.dtype == f64 and all(j.dtype == f64 for j in J1),
          "config 1 in float64 is not float64")
    check(worst <= 1.0 and ratio <= 1.0,
          "config 1 in float64 misses its budgets")

    # (h) The LTE table built in float64: one K1, against the float32-cast
    # plain build at every node.
    cfgL = cli.load_config(SCENE, {**LUT_CLI, **F64_CLI})
    sceneL, n = counted(lambda: timed("(h) table build", lambda:
                                      cli.build_scene(cfgL, dev)))
    expect_launches("the float64 table build", n, K1=1)
    plain = lut.build_lut(sceneL.nu, sceneL.lines,
                          len(sceneL.species_names), engine=cast,
                          **cli.lut_lattice(cfgL, sceneL.atm,
                                            sceneL.species_names, sceneL.chi,
                                            sceneL.nu_off))
    err, worst = table_error(sceneL.lut, plain)
    print(f"6l (h) LTE table build float64 ({sceneL.lut.sigma.dtype}): "
          f"launches {json.dumps(n)}; vs the float32-cast plain build max "
          f"|err| {err:.3e}, {worst:.3e} x K1's budget")
    check(sceneL.lut.sigma.dtype == f64 and worst <= 1.0,
          "the float64 table disagrees with the float32-cast plain build")
    del plain, sceneL

    # (i) The (1, 1, 1) mesh forward in float64, both tiers: the first call
    # (the eager body, then its capture) and a replay, bit-equal, one K1
    # each, within MESH_RTOL of one device.
    empty = make_state(scene64.atm, [], retrieve_temperature=False)
    x_e = flatten_state(empty)[0]
    I_one = cli.run_forward(cfg64, scene64).cpu().numpy()
    for tier, halo_on in (("psum", False), ("nu-halo", True)):
        cfg_t = dataclasses.replace(cfg64, compute=dataclasses.replace(
            cfg64.compute, mesh_halo=halo_on))
        oe = cli.sharded_problem(cfg_t, scene64, mesh, scene64.atm, empty)
        I_m, n = counted(lambda: oe.forward_flat(x_e))
        reset_launches()
        traced, I_r = ho.traced_launches(lambda: oe.forward_flat(x_e), dev)
        n_r = launch_counts()
        check(traced == launch.LAUNCHES,
              f"the float64 {tier} replay traced {json.dumps(traced)}, its "
              f"counts say {json.dumps(launch.LAUNCHES)}")
        expect_launches(f"the float64 {tier} mesh forward", n, K1=1)
        expect_launches(f"the float64 {tier} mesh replay", n_r, K1=1)
        err = rel_max(I_m.reshape(I_one.shape), I_one)
        print(f"6l (i) (1, 1, 1) mesh forward float64, {tier} tier "
              f"({I_m.dtype}): replay bit-equal to the eager first call "
              f"{bool(torch.equal(I_r, I_m))}, launches {json.dumps(n_r)} "
              f"as its trace shows; vs one device {err:.3e} of max")
        check(I_m.dtype == f64 and torch.equal(I_r, I_m),
              f"the float64 {tier} mesh replay differs from its eager call")
        check(err <= MESH_RTOL, f"the float64 {tier} mesh forward is off "
                                f"one device")

    # (j) compute.use_pallas = false in float32: the CLI forward and the
    # Jacobian on the plain engine, no launch, against the kernels'.
    cfg_np = cli.load_config(SCENE, NO_PALLAS_CLI)
    with tempfile.TemporaryDirectory() as tmp:
        res, n, _ = timed("(j) CLI forward, use_pallas = false, float32",
                          lambda: cli_run("forward", NO_PALLAS_CLI, tmp))
    expect_launches("the float32 CLI forward with use_pallas = false", n)
    err, worst = sum_error(res["values"], I)
    p = cli.retrieval_problem(cfg_np, scene, cli.select_engine(cfg_np, dev))
    J_np, n_j = counted(lambda: timed(
        "(j) Jacobian, use_pallas = false, float32", lambda: cli.make_jacobian(
            cfg_np, p.fwd_flat, int(p.x0.shape[0]), int(scene.nu.shape[0]),
            dev)(p.x0)))
    expect_launches("the float32 Jacobian with use_pallas = false", n_j)
    print(f"6l (j) use_pallas = false, float32: forward vs the kernels' "
          f"max |err| {err:.3e}, "
          f"{worst:.3e} x K1's budget; Jacobian {J_np.dtype} vs the kernels' "
          f"{rel_max(J, J_np):.3e} of max |K|; launches {json.dumps(n)}, "
          f"{json.dumps(n_j)}; float64 (b, c): launches "
          f"{json.dumps(n_pure)}, {json.dumps(jacs['pure'][1])}")
    check(worst <= 1.0 and rel_max(J, J_np) <= K2_REL,
          "use_pallas = false disagrees with the kernels")

    # Walls beside float32's (CUDA events, median of 5; the forward by the
    # host clock, median of 3 after a warm-up).
    rev32 = cli.retrieval_problem(cfg, scene, KERNELS, analytic_jvp="rev")
    p32 = cli.retrieval_problem(cfg, scene, KERNELS)
    jac32 = cli.make_jacobian(cfg, p32.fwd_flat, int(p32.x0.shape[0]),
                              int(scene.nu.shape[0]), dev)
    y32, s32 = y_obs.float(), sig.float()
    pairs = {
        "forward": (lambda: cli.run_forward(cfg64, scene64, KERNELS),
                    lambda: cli.run_forward(cfg, scene, KERNELS), wall_ms),
        "Jacobian": (lambda: jac64(probs["kernels"].x0),
                     lambda: jac32(p32.x0), cuda_ms),
        "reverse gradient": (lambda: cost_grad(rev["kernels"], y_obs, sig),
                             lambda: cost_grad(rev32, y32, s32), cuda_ms)}
    for name, (f64_call, f32_call, clock) in pairs.items():
        walls[name] = (clock(f64_call), clock(f32_call))
        print(f"time 6l {name} [{card}]: float64 through the kernels "
              f"{walls[name][0]:.2f} ms, float32 {walls[name][1]:.2f} ms")
    for name in [k for k in walls if k.startswith("(")]:
        print(f"time 6l {name} [{card}]: {walls[name]:.1f} ms (one call)")
    print(f"time 6l [{card}]: {time.perf_counter() - t_phase:.1f} s")
    return walls


# Phase 6i: the measurement tools (bench, jac_kernel_bench, scaling,
# trace_summary, run_demo) on the card, at the reference's TPU sizes.
# The launches per call each bench scene must make.
FWD_JAC_LAUNCHES = {"forward": {"K1": 1, "K2": 0, "K3": 0},
                    "jacobian": {"K1": 1, "K2": 1, "K3": 0}}
BENCH_LAUNCHES = {
    "limb_scan_forward_jacobian_wall_s": FWD_JAC_LAUNCHES,
    "fused_pallas_forward_jacobian_wall_s": FWD_JAC_LAUNCHES,
    "voigt_opacity_dense_evals_per_s_per_chip": {"K1": 0, "K2": 0, "K3": 1}}
# FP32 peak of the H100 SXM data sheet; a measured FMA ceiling may not
# pass it by more than FMA_SLACK (clocks above base), nor the dense
# kernel's required flops the measured ceiling.
FMA_SLACK = 1.05


def tools_phase(dev, mesh, card: str) -> dict:
    """Phase 6i on the card: the bench's limb-scan and fused scenes
    through the kernels against the plain engine; (a) ``bench.run``'s six
    measurements at the reference's TPU sizes (every value finite and
    positive; the launches per call of each scene; the mesh forward within
    MESH_RTOL of one device; the FMA ceiling and the dense kernel's share
    of it); then the FMA kernel bit-equal to its plain chain; (b)
    ``jac_kernel_bench``'s line; (c) ``scaling`` at n = 1 in both tiers on
    ``mesh`` (phase 6c's (1, 1, 1) mesh) with its 1-device overhead
    record; (d) ``trace_summary``'s families of the fused Jacobian (K2's
    kernel among them); (e) ``run_demo`` into a temporary directory
    (converged, mean |dT| below the 7 K start, its spectrum file and, where
    matplotlib is installed, its figures written).  Each sub-phase's wall
    time beside ``card``.  Returns the bench's launches, the FMA kernel's
    row and its times."""
    from spectrobot_tpu_torch import (
        bench, jac_kernel_bench, run_demo, scaling, trace_summary)
    from spectrobot_tpu_torch.ops import cuda_fma
    from spectrobot_tpu_torch.ops.cuda_basis import PLAIN
    from spectrobot_tpu_torch.roofline import FP32_FLOPS

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        print(f"time 6i {name} [{card}]: {time.perf_counter() - t0:.2f} s")
        return out

    # The bench's two limb scenes through the kernels (K1 in the forward,
    # K1 and K2 at R = 2 n_x in the Jacobian) against the plain engine on
    # the same x0, before any timing: K1's budget on the radiances, K2's
    # on the Jacobian.
    for name, scene in (("limb scan", bench.limb_scan_scene),
                        ("fused", bench.fused_scene)):
        got, ref = timed(f"{name} scene vs plain", lambda: [
            (fwd(x0), jac(x0)) for fwd, jac, x0 in (
                scene(dev), scene(dev, engine=PLAIN))])
        (I, J), (I_ref, J_ref) = got, ref
        worst = float(((I - I_ref).abs() / (
            RTOL * I_ref.abs() + ATOL_REL * I_ref.abs().max())).max())
        j_err, j_max = float((J - J_ref).abs().max()), float(
            J_ref.abs().max())
        print(f"bench {name} scene, kernels vs plain: radiances "
              f"{tuple(I.shape)} at {worst:.3e} of K1's budget; Jacobian "
              f"{tuple(J.shape)} max |err| {j_err:.3e} of max |ref| "
              f"{j_max:.3e} ({j_err / (K2_REL * j_max):.3e} of K2's budget)")
        check(bool(torch.isfinite(I).all() and torch.isfinite(J).all()),
              f"the bench {name} scene: non-finite output")
        check(worst <= 1.0, f"the bench {name} scene's radiances disagree "
                            f"with the plain engine's")
        check(j_err <= K2_REL * j_max, f"the bench {name} scene's Jacobian "
                                       f"disagrees with the plain engine's")
        del got, ref, I, J, I_ref, J_ref

    # (a) The six measurements; one timed chain each (the sizes stay).
    reset_launches()
    records = timed("bench", lambda: bench.run(dev, n_rep=1))
    n = launch_counts()
    print(f"bench launches: {json.dumps(n)}")
    for r in records:
        check(math.isfinite(r["value"]) and r["value"] > 0,
              f"bench {r['metric']}: value {r['value']}")
        want = BENCH_LAUNCHES.get(r["metric"])
        if want is not None:
            got = r["launches_per_call"]
            check(got == want, f"bench {r['metric']} launched {got} a "
                               f"call, not {want}")
    check(all(n[k] > 0 for k in ("K1", "K2", "K3", "fma_peak")),
          f"the bench did not launch every kernel of its path: {n}")
    by = {r["metric"]: r for r in records}
    diff = by["sharded_pallas_forward_wall_s"]["max_rel_diff_vs_single"]
    check(diff <= MESH_RTOL, f"the bench's mesh forward is {diff:.3e} of "
                             f"max off the single device's")
    roof = by["kernel_roofline_pct_of_fp32_peak"]
    check(roof["fma_ceiling_flops"] <= FMA_SLACK * FP32_FLOPS,
          f"FMA ceiling {roof['fma_ceiling_flops']:.4g} FLOP/s above the "
          f"data sheet's {FP32_FLOPS:.4g}")
    check(roof["value"] <= 100 * FMA_SLACK,
          f"the dense kernel at {roof['value']:.1f} % of the FMA ceiling")

    # The FMA kernel against its plain chain (fmaf emulated exactly), bit
    # for bit at both timed depths, on the bench's own input (ones) and on
    # random values of the same size.
    N = roof["fma_elements"]
    ones = torch.ones(N, device=dev)
    fma_err = 0.0
    for name, x in (("ones", ones), ("random", torch.rand(
            N, device=dev, generator=torch.Generator(dev).manual_seed(70))
            + 0.5)):
        for depth in (64, 256):
            got = cuda_fma.fma_chain(x, bench.FMA_A, bench.FMA_B, depth)
            ref = cuda_fma.fma_chain_plain(x, bench.FMA_A, bench.FMA_B,
                                           depth)
            err = float((got - ref).abs().max())
            fma_err = max(fma_err, err)
            print(f"FMA kernel vs plain chain, {N} {name} floats, depth "
                  f"{depth}: max |err| {err:.3e}, "
                  f"{int(got.ne(ref).sum())} elements differ")
            check(torch.equal(got, ref), f"the FMA kernel is not bit-equal "
                                         f"to its plain chain at depth "
                                         f"{depth} ({name})")
    depth = max(int(k) for k in roof["fma_ceiling_by_depth"])
    fma_ms = 1e3 * 2.0 * depth * N / roof["fma_ceiling_by_depth"][str(depth)]
    fma_plain_ms = cuda_ms(lambda: cuda_fma.fma_chain_plain(
        ones, bench.FMA_A, bench.FMA_B, depth), n=3)
    t_ops, t_bytes = 2.0 * depth * N / FP32_FLOPS, 8.0 * N / HBM_BYTES_S
    fma_bound = (1e3 * max(t_ops, t_bytes),
                 "operations" if t_ops >= t_bytes else "bytes")
    print(f"time FMA kernel [{card}]: depth {depth} on {N} floats "
          f"{fma_ms:.4f} ms (bench's chain), plain chain {fma_plain_ms:.3f} "
          f"ms, bound {fma_bound[0]:.4f} ms ({fma_bound[1]})")

    # (b) The Jacobian timer.
    timed("jac_kernel_bench", lambda: jac_kernel_bench.main(
        ["chip_smoke", "--n-rep", "1"]))

    # (c) Weak scaling at n = 1 in both tiers, and the overhead record.
    dl, cg = scaling.scene(dev, torch.float32)
    over = timed("scaling overhead", lambda: scaling.overhead_record(
        mesh, dl, cg, 2048, reps=5))
    print(json.dumps(over))
    for halo in (False, True):
        (rec,) = scaling.with_efficiency([timed(
            f"scaling {'nu-halo' if halo else 'psum'}",
            lambda: scaling.scaling_record(mesh, dl, cg, 2048, 5, halo))])
        print(json.dumps(rec))
        check(math.isfinite(rec["wall_s"]) and rec["wall_s"] > 0,
              f"scaling: wall {rec['wall_s']}")
    check(all(math.isfinite(over[k]) and over[k] > 0
              for k in ("t_plain_s", "t_mesh_s")),
          f"scaling overhead record {over}")

    # (d) The fused Jacobian's device time by family.
    with tempfile.TemporaryDirectory() as tmp:
        rows = timed("trace_summary", lambda: trace_summary.capture(
            dev, "jac", reps=3, log_dir=tmp))
    total = sum(r[0] for r in rows)
    print(f"trace_summary jac: device total per call {total:.3f} ms")
    for row in rows[:trace_summary.TOP]:
        flag = ("  <-- per-segment loop?"
                if trace_summary.flagged(row, total) else "")
        print(f"  {row[0]:10.3f} ms  x{row[1]:8.1f}  {row[2][:100]}{flag}")
    check(any("basis_batch_kernel" in r[2] for r in rows),
          "the fused Jacobian's trace holds no K2 (basis_batch_kernel)")

    # (e) The library walkthrough.
    # The two figures need matplotlib, which a machine may lack (the
    # figures are optional, as the CLI's are); the spectrum file does not.
    want = ["limb_spectrum.npz"] + (
        ["limb_radiances.png", "retrieved_T.png"]
        if importlib.util.find_spec("matplotlib") else [])
    with tempfile.TemporaryDirectory() as tmp:
        demo = timed("run_demo", lambda: run_demo.run(dev, tmp))
        files = {f: os.path.getsize(os.path.join(tmp, f))
                 for f in os.listdir(tmp)}
    dT = float(np.abs(demo["res"].x - demo["x_true"]).mean())
    print(f"run_demo: converged {demo['res'].converged} in "
          f"{demo['res'].n_iter} LM iterations, mean |dT| {dT:.3f} K; files "
          f"{json.dumps(files)}")
    check(demo["res"].converged, "run_demo's retrieval did not converge")
    check(dT < 7.0, f"run_demo's mean |dT| {dT:.3f} K is not below 7 K")
    check(sorted(files) == sorted(want)
          and all(v > 0 for v in files.values()),
          f"run_demo wrote {files}, not {want}")
    return {"fma": {"launches": n["fma_peak"], "max_abs_err": fma_err,
                    "ms": fma_ms, "plain_ms": fma_plain_ms,
                    "bound": fma_bound}}


def halo_overlap_phase(dev, cfg, scene, mesh: dict, card: str) -> None:
    """Phase 6j on phase 6c's (1, 1, 1) mesh: the nu-halo forward issues
    no exchange (one nu shard, no hop), launches K1 once and equals the
    single-device forward within MESH_RTOL; the trace tool's analysis
    (spectrobot_tpu_torch.halo_overlap.measure) of its one-card trace
    finds device events and 0 exchange launches in every forward."""
    from spectrobot_tpu_torch import cli, halo_overlap

    oe, x = mesh["fwd_nu-halo"], mesh["x_empty"]
    I_single = cli.run_forward(cfg, scene).cpu().numpy()
    fwd = lambda: oe.forward_flat(x)
    reset_launches()
    I = fwd()
    torch.cuda.synchronize()
    n = launch_counts()
    I = I.reshape(I_single.shape).cpu().numpy()
    print(f"6j: (1, 1, 1) nu-halo forward vs single-device: max |err| "
          f"{float(np.abs(I - I_single).max()):.3e} of max "
          f"{float(np.abs(I_single).max()):.3e}; launches {json.dumps(n)}")
    expect_launches("the (1, 1, 1) nu-halo forward", n, K1=1)
    np.testing.assert_allclose(I, I_single, rtol=MESH_RTOL,
                               atol=MESH_RTOL * np.abs(I_single).max())
    res = halo_overlap.measure(fwd, dev, n_forwards=3, n_walls=5)
    print(f"6j: halo_overlap.measure of the (1, 1, 1) nu-halo forward "
          f"[{card}]: wall {json.dumps(res['forward_wall_ms'])}; summary "
          f"{json.dumps(res['summary'])}")
    check(all(f["busy_us"] for f in res["forwards"]),
          "a traced (1, 1, 1) nu-halo forward holds no device event")
    check(all(f["n_exchange_launches"] == 0 for f in res["forwards"]),
          "the (1, 1, 1) nu-halo forward launched an exchange")


def release_cache(before: str) -> None:
    """Free the allocator's cached blocks and print what it held."""
    reserved = torch.cuda.memory_reserved() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory before {before}: reserved {reserved:.2f} GB "
          f"-> {torch.cuda.memory_reserved() / 1e9:.2f} GB (allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB)")


def wall_ms(fn, n: int = 3) -> float:
    """Median host wall of ``fn`` (to the device's end) over ``n`` calls
    after a warm-up [ms]."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(walls))


def host_ms(fn, n: int = 20) -> tuple:
    """Host clock over ``n`` calls of ``fn`` back to back after a warm-up
    [ms a call]: (until the last is issued, until the device is done)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return 1e3 * (t1 - t0) / n, 1e3 * (t2 - t0) / n


def dense_centers(dev, n_lines: int = 20480) -> torch.Tensor:
    """The unshifted centers of the dense shape's lines (k3_cases')."""
    from spectrobot_tpu_torch.data.lines import random_lines
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist

    return device_lines_from_linelist(
        random_lines(n_lines, 600.0, 740.0, seed=0), [(2, 1)],
        dtype=torch.float32, device=dev, nu_ref=0.0).nu0


def halo_partition(case: K3Case, nu0: torch.Tensor, n: int,
                   cut: Optional[float], round_to: int = 128):
    """The case's lines partitioned over ``n`` nu shards of its grid
    (``ShardedKernelLines``, each shard padded to a common multiple of
    ``round_to`` lines)."""
    from spectrobot_tpu_torch.ops.opacity import KernelLines
    from spectrobot_tpu_torch.parallel import halo

    edges = halo.nu_shard_edges(case.nu.double().cpu().numpy(), n, cut)
    return halo.partition_kernel_lines(
        KernelLines(case.nu_c, case.sx, case.y, case.amps), nu0, edges,
        round_to=round_to)


def dma_phase(dev, bench: K3Case, bench_nu0: torch.Tensor, dense: K3Case, *,
              dense_lines=20480, miss_rounds: int = 0) -> dict:
    """Phase 6e: the remote-copy halo tier on the loopback ring of this
    card, through spectrobot_tpu_torch.dma_halo's entry points.  Each call
    runs twice in a row (the epoch protocol across calls).  Returns the
    launch counts, the errors, the times and the bounds of the ring and
    fused kernels.  ``miss_rounds`` > 0 also measures the profiler's miss
    rate on the fused cases (:func:`profiler_misses`)."""
    import types

    from spectrobot_tpu_torch import dma_halo
    from spectrobot_tpu_torch.ops.opacity import KernelLines
    from spectrobot_tpu_torch.parallel import cuda_dma as cd
    from spectrobot_tpu_torch.parallel import halo
    from spectrobot_tpu_torch.parallel.peer import loopback_ring

    dense_nu0 = dense_centers(dev, dense_lines)
    rings = {n: loopback_ring(n, dev) for n in (1, 2, 3, 4, 8)}
    fused_cases = [("bench state", bench, bench_nu0, n, 25.0)
                   for n in (1, 2, 4)]
    fused_cases += [("bench state", bench, bench_nu0, 8, 10.0),
                    ("dense", dense, dense_nu0, 4, 10.0)]
    parts = {(name, n, cut): halo_partition(c, nu0, n, cut)
             for name, c, nu0, n, cut in fused_cases}
    # The bench state's lines with shard 1's row shuffled (its padding among
    # its lines); on 8184 points (P_loc 2046) with L = the longest shard's
    # lines, neither a multiple of 128; with 1 and 8 amplitude rows.
    g = np.random.default_rng(62)
    skl = parts["bench state", 4, 25.0]
    perm = torch.as_tensor(g.permutation(skl.nu_c.shape[1]), device=dev)
    parts["bench state, shard 1 shuffled", 4, 25.0] = halo.ShardedKernelLines(
        *(torch.cat([a[:1], a[1:2][..., perm], a[2:]]) for a in skl))
    ragged = bench._replace(nu=bench.nu[:8184])
    parts["bench state, ragged", 4, 25.0] = halo_partition(
        ragged, bench_nu0, 4, 25.0, round_to=1)
    w8 = torch.as_tensor(g.uniform(0.5, 1.5, (8, bench.amps.shape[1])),
                         dtype=torch.float32, device=dev)
    by_rows = {1: bench._replace(amps=bench.amps[:1].contiguous()),
               8: bench._replace(amps=(w8 * bench.amps[:1]).contiguous())}
    for n_out, n in ((1, 2), (8, 4)):
        parts[f"bench state, n_out {n_out}", n, 25.0] = halo_partition(
            by_rows[n_out], bench_nu0, n, 25.0)
    fused_cases += [("bench state, shard 1 shuffled", bench, None, 4, 25.0),
                    ("bench state, ragged", ragged, None, 4, 25.0),
                    ("bench state, n_out 1", by_rows[1], None, 2, 25.0),
                    ("bench state, n_out 8", by_rows[8], None, 4, 25.0)]
    g = torch.Generator(device=dev).manual_seed(60)
    # Blocks of 64 x 1000 floats a shard, and ragged ones of 7 x 143 (1001
    # floats: not a multiple of 4 or of a copy item).
    shapes = {(64, 1000): (2, 4, 8), (7, 143): (1, 2, 3, 4, 8)}
    xs = [(n, torch.randn((n * rows, cols), generator=g, device=dev))
          for (rows, cols), ns in shapes.items() for n in ns]
    back = [torch.randn((3 * 7, 143), generator=g, device=dev)
            for _ in range(50)]
    dense4 = parts["dense", 4, 10.0]

    def rolled(x, n, direction):
        return torch.roll(x.reshape(n, -1, x.shape[1]), direction,
                          0).reshape(x.shape)

    # The main path: every entry point, the counts read just after.
    reset_launches()
    rolls, fused = [], {}
    for n, x in xs:
        for direction in (1, -1):
            f = dma_halo.ring_exchange(rings[n], "nu", direction)
            for _ in range(2):
                rolls.append((f"ring n={n} {tuple(x.shape)} "
                              f"dir={direction:+d}", f(x),
                              rolled(x, n, direction)))
    # 50 calls back to back on 3 shards, the directions in turns (the epoch
    # and the per-chunk arrival flags across calls).
    fs = {d: dma_halo.ring_exchange(rings[3], "nu", d) for d in (1, -1)}
    outs = [fs[1 if i % 2 else -1](x) for i, x in enumerate(back)]
    rolls += [(f"ring n=3 back to back, call {i}", got,
               rolled(x, 3, 1 if i % 2 else -1))
              for i, (x, got) in enumerate(zip(back, outs))]
    for _ in range(2):
        left, right = dma_halo.ring_halo_lines(rings[4], dense4)
        for got, shift in ((left, 1), (right, -1)):
            rolls += [(f"halo lines {name} shift {shift:+d}", a,
                       torch.roll(b, shift, 0))
                      for name, a, b in zip(halo.ShardedKernelLines._fields,
                                            got, dense4)]
    for name, c, _, n, cut in fused_cases:
        f = dma_halo.fused_halo_accumulate_fn(rings[n], cutoff_cm1=cut)
        fused[name, n, cut] = [f(c.nu, parts[name, n, cut])
                               for _ in range(2)]
    torch.cuda.synchronize()
    n_calls = launch_counts()
    print(f"remote-copy tier (loopback, one card): launches "
          f"{json.dumps(n_calls)}")
    expect_launches("the remote-copy tier", n_calls,
                    dma_ring=len(xs) * 2 * 2 + len(back) + 2 * 2,
                    dma_halo=2 * len(fused_cases))

    for what, got, want in rolls:
        check(torch.equal(got, want), f"{what}: not bit-equal to the roll")
    ring_err = max(float((got - want).abs().max()) for _, got, want in rolls)
    print(f"ring_exchange (n = 2, 4, 8 at 64 x 1000 floats a shard and n = "
          f"1, 2, 3, 4, 8 at 7 x 143, both directions, twice each; 50 calls "
          f"back to back at n = 3) and ring_halo_lines (dense case, 4 "
          f"shards, twice): {len(rolls)} results bit-equal to the roll")
    if miss_rounds:
        def maker(c, n, cut, skl):
            def make():
                f = dma_halo.fused_halo_accumulate_fn(rings[n],
                                                      cutoff_cm1=cut)
                return lambda: f(c.nu, skl)
            return make
        profiler_misses([maker(c, n, cut, parts[name, n, cut])
                         for name, c, _, n, cut in fused_cases], miss_rounds)
    rows = {}
    for name, c, _, n, cut in fused_cases:
        skl = parts[name, n, cut]
        packed_c = halo.pack_lines(KernelLines(*skl))
        plain = cd.fused_halo_accumulate_plain(
            rings[n], c.nu.reshape(n, -1), packed_c, cutoff_cm1=cut)
        ref = plain.transpose(0, 1).reshape(plain.shape[1], -1)
        got = fused[name, n, cut]
        check(torch.equal(got[0], got[1]),
              f"{name}, {n} shards: the two calls differ")
        check(bool(torch.isfinite(got[0]).all()),
              f"{name}, {n} shards: non-finite fused sum")
        err = (got[0] - ref).abs()
        worst = float((err / (RTOL * ref.abs() + ATOL_REL * ref.abs().max()))
                      .max())
        f = dma_halo.fused_halo_accumulate_fn(rings[n], cutoff_cm1=cut)
        kernels = device_kernels(lambda: f(c.nu, skl))
        row = rows[name, n, cut] = {
            "case": name, "shards": n, "cutoff": cut,
            "lines": int(c.nu_c.shape[0]), "Lmax": int(skl.nu_c.shape[1]),
            "points": int(c.nu.shape[0]), "rows": int(skl.amps.shape[1]),
            "blocks_visited": cd.blocks_visited(c.nu.reshape(n, -1),
                                                packed_c, cut),
            "device_kernels_in_3_calls": len(kernels),
            "max_abs_err": float(err.max()),
            "max_ref": float(ref.abs().max()),
            "budget": f"{RTOL:g}*|ref| + {ATOL_REL:g}*max|ref|",
            "err_over_budget": worst}
        print(f"dma_halo vs plain: {json.dumps(row)}")
        check(worst <= 1.0, f"{name}, {n} shards: the fused halo sum "
                            f"disagrees with its plain version")
        check(1 <= len(kernels) <= 3 and all("dma_halo_kernel" in k
                                             for k in kernels),
              f"{name}, {n} shards: a fused call ran device kernels other "
              f"than its one launch: {kernels}")
    shapes = {(r["Lmax"] % 128, (r["points"] // r["shards"]) % 128)
              for (name, _, _), r in rows.items() if "ragged" in name}
    check(all(a and b for a, b in shapes),
          f"the ragged case is not ragged: {shapes}")

    # Times at the dense case on 4 shards (the full-width case), and bounds.
    packed = halo.pack_lines(KernelLines(*dense4)).contiguous()
    r4 = rings[4]
    times = {"dma_ring": (cuda_ms(lambda: cd.ring_exchange_cuda(r4, packed,
                                                                 1)),
                          cuda_ms(lambda: cd.ring_exchange_plain(r4, packed,
                                                                  1)),
                          cuda_ms(lambda: torch.roll(packed, 1, 0)))}
    f = dma_halo.fused_halo_accumulate_fn(r4, cutoff_cm1=10.0)
    nu4 = dense.nu.reshape(4, -1)
    entry = lambda: f(dense.nu, dense4)
    wrapper = lambda: cd.fused_halo_accumulate_cuda(r4, nu4, packed,
                                                    cutoff_cm1=10.0)
    times["dma_halo"] = (
        cuda_ms(entry),
        cuda_ms(lambda: cd.fused_halo_accumulate_plain(
            r4, nu4, packed, cutoff_cm1=10.0)), None)
    fused_split = {"wrapper": cuda_ms(wrapper),
                   "kernel alone": kernel_ms(entry, "dma_halo_kernel")}
    pairs = dict.fromkeys(REGIONS, 0)
    no_windows = types.SimpleNamespace(cutoff_cm1=10.0)
    for k in range(4):
        rows_k = torch.cat([packed[k], packed[(k - 1) % 4],
                            packed[(k + 1) % 4]], dim=-1)
        one = K1Case("dense shard", nu4[k], no_windows, rows_k[0][None],
                     rows_k[1][None], rows_k[2][None], rows_k[3:][None], None)
        for r, v in case_region_counts(one, torch.ones(
                1, dtype=torch.bool, device=dev)).items():
            pairs[r] += v
    n_out, P = packed.shape[1] - 3, dense.nu.shape[0]
    bounds = {
        # Each block read once and written once by the roll.
        "dma_ring": (1e3 * 2.0 * 4 * packed.numel() / HBM_BYTES_S, "bytes"),
        "dma_halo": bound_ms(pairs, REGION_FLOPS, 4.0 + 2 * n_out,
                             4.0 * (P + packed.numel() + n_out * P))}
    ring = lambda: cd.ring_exchange_cuda(r4, packed, 1)
    roll = lambda: torch.roll(packed, 1, 0)
    host = {name: host_ms(fn) for name, fn in (
        ("dma_ring", ring), ("torch.roll", roll), ("dma_halo", entry),
        ("dma_halo wrapper", wrapper))}
    for name, (issue, total) in host.items():
        print(f"host time {name}: {issue:.4f} ms a call to issue, "
              f"{total:.4f} ms a call to finish (20 calls back to back)")
    print(f"time dma_ring (loopback, 4 shards x {tuple(packed.shape[1:])} "
          f"packed rows of the dense case): kernel "
          f"{times['dma_ring'][0]:.4f} ms (CUDA events around the call; "
          f"device {kernel_ms(ring, 'dma_ring_kernel'):.4f} ms, host issue "
          f"{host['dma_ring'][0]:.4f} ms), plain {times['dma_ring'][1]:.4f} "
          f"ms, torch.roll {times['dma_ring'][2]:.4f} ms (device "
          f"{kernel_ms(roll, 'roll'):.4f} ms, host issue "
          f"{host['torch.roll'][0]:.4f} ms); bound "
          f"{bounds['dma_ring'][0]:.5f} ms (bytes)")
    visited = rows["dense", 4, 10.0]["blocks_visited"]
    print(f"time dma_halo (loopback, dense shape, 4 shards, cutoff 10): "
          f"entry point {times['dma_halo'][0]:.4f} ms, wrapper "
          f"{fused_split['wrapper']:.4f} ms (CUDA events around the call), "
          f"kernel alone {fused_split['kernel alone']:.4f} ms "
          f"(torch.profiler), host issue {host['dma_halo'][0]:.4f} ms "
          f"(wrapper {host['dma_halo wrapper'][0]:.4f} ms); plain "
          f"{times['dma_halo'][1]:.3f} ms; blocks visited {visited[0]} of "
          f"{visited[1]}; in-cutoff pairs by region {json.dumps(pairs)}; "
          f"bound {bounds['dma_halo'][0]:.4f} ms ({bounds['dma_halo'][1]})")
    for r in rings.values():
        r.close()
    return {"launches": n_calls, "rows": rows, "times": times,
            "bounds": bounds, "ring_err": ring_err}


def case_region_counts(case: K1Case, live: torch.Tensor) -> dict:
    """``roofline.region_counts`` of the ``live`` states [B] of a case."""
    return region_counts(case.nu, case.nu_c, case.sx, case.y, live,
                         case.windows.cutoff_cm1)


# Host seconds a profiler window waits before the calls it records.
PROFILER_SETTLE_S = 0.05


def kernel_ms(call, kernel: str, n: int = 10) -> float:
    """Mean device time of a launch of the kernel named ``kernel`` over
    ``n`` calls [ms] (``torch.profiler``; per launch recorded, as the
    profiler may miss one; 0 when no such kernel ran)."""
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


def profiler_window(call, n: int, settle: float) -> list:
    """The names of the device kernels that one torch.profiler window
    records over ``n`` calls of ``call``, begun after ``settle`` seconds of
    host wait inside the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(settle)
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_kernels(call, n: int = 3, windows: int = 3) -> list:
    """The names of the device kernels that ``n`` warm calls of ``call``
    launch, from the first of up to ``windows`` profiler windows that
    records any (``torch.profiler`` may miss the events of a window's
    ctypes launches, but adds none).  Each window waits
    ``PROFILER_SETTLE_S`` on the host before its calls: windows that began
    their calls at once recorded no launch in 8 of 720, those that waited
    in none of 720 (``profiler_misses``, 20 and 60 rounds in two runs on
    the card)."""
    call()
    torch.cuda.synchronize()
    for _ in range(windows):
        names = profiler_window(call, n, PROFILER_SETTLE_S)
        if names:
            break
    return names


def profiler_misses(makers: list, rounds: int) -> None:
    """How often a profiler window misses the fused-halo kernel (``python3
    chip_smoke.py --profiler-misses ROUNDS``, in phase 6e): for each case
    (``makers``: each makes a fresh call) and round, a fresh call and
    its warm-up, then one window of 3 calls with no wait and one with
    ``PROFILER_SETTLE_S`` (in turns, the first alternating by round).  Per
    wait: windows, windows that record no launch, windows that record
    fewer than 3, and the longest run of windows without a record."""
    stats = {w: {"windows": 0, "none": 0, "short": 0, "longest_none_run": 0,
                 "_run": 0} for w in (0.0, PROFILER_SETTLE_S)}
    for r in range(rounds):
        for make in makers:
            call = make()
            call()
            torch.cuda.synchronize()
            order = (0.0, PROFILER_SETTLE_S)
            for w in (order if r % 2 else order[::-1]):
                k = sum("dma_halo_kernel" in name
                        for name in profiler_window(call, 3, w))
                st = stats[w]
                st["windows"] += 1
                st["none"] += k == 0
                st["short"] += k < 3
                st["_run"] = st["_run"] + 1 if k == 0 else 0
                st["longest_none_run"] = max(st["longest_none_run"],
                                             st["_run"])
    out = {f"settle {w} s": {k: v for k, v in st.items() if k != "_run"}
           for w, st in stats.items()}
    print(f"profiler misses over {len(makers)} fused-halo cases x {rounds} "
          f"rounds: {json.dumps(out)}")


def epilogue_bytes(R, NL, P, n_seg, n_t, rows, itemsize, tangent) -> float:
    """The fused epilogue's least bytes: the depths' ``rows`` (1 in LTE, 2
    in non-LTE) of [R, NL, P], T_air and the grid read once; a tangent
    call also reads each column's depth tangents and T_air tangent and
    writes [n_t, R, P], a primal call writes [R, P]."""
    prim = rows * R * NL * P + R * NL + P
    if not tangent:
        return float(prim + R * P) * itemsize
    return float(prim + n_t * (rows * R * NL * P + R * NL + R * P)) * itemsize


def epilogue_cases():
    """tests/epilogue_cases.py: the cells' ray sets in K2's layout."""
    tests = os.path.join(REPO, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import epilogue_cases as cases
    return cases


def epilogue_phase(dev, card: str) -> dict:
    """Phase 4d: the fused RT epilogue at the cells' shapes, float32,
    against the composed epilogue.  Returns the "port_kernels" row of
    mars43_nlte_fov's tangent (the kernel's largest call in the benchmark;
    its launches are the main path's, set in phase 6)."""
    from spectrobot_tpu_torch.ops import cuda_epilogue as ce

    cases = epilogue_cases()
    for name, (R, NL, P, n_t, nlte, grid) in cases.CELLS.items():
        prim, tan, _ = cases.case(dev, torch.float32, R, NL, P, n_t, nlte,
                                  grid)
        before = launch_counts()["epilogue"]
        I = ce.radiance(*prim)
        dI = ce.radiance_tangent(*prim, *tan)
        torch.cuda.synchronize()
        n = launch_counts()["epilogue"] - before
        check(n == 2, f"4d {name}: {n} epilogue launches, not 2")
        composed = ce.composed_tangent(*prim, *tan)
        errs = {"primal": rel_max(I, ce.composed_radiance(*prim)),
                "tangent": rel_max(dI, composed)}
        max_abs_err = float((dI - composed).abs().max())
        del composed
        for what, err in errs.items():
            check(err <= EPILOGUE_REL[what], f"4d {name}: {what} error "
                  f"{err:.3e} > {EPILOGUE_REL[what]:g} (vs the composed "
                  f"epilogue)")
        reps = 10
        ms = {"tangent": cuda_ms(lambda: [ce.radiance_tangent(*prim, *tan)
                                          for _ in range(reps)]) / reps,
              "primal": cuda_ms(lambda: [ce.radiance(*prim)
                                         for _ in range(reps)]) / reps}
        gc.collect()
        torch.cuda.empty_cache()
        ms["composed tangent"] = cuda_ms(
            lambda: ce.composed_tangent(*prim, *tan))
        rows = 2 if nlte else 1
        n_seg = int(prim[4].shape[0])
        bound = {k: epilogue_bytes(R, NL, P, n_seg, n_t, rows, 4,
                                   k == "tangent") / HBM_BYTES_S * 1e3
                 for k in ("tangent", "primal")}
        print(f"4d fused epilogue, {name} [{card}]: R = {R}, NL = {NL}, "
              f"P = {P}, n_t = {n_t}, {'non-LTE' if nlte else 'LTE'}; "
              f"tangent {ms['tangent']:.4f} ms vs bound "
              f"{bound['tangent']:.4f} ms (bytes; "
              f"{100 * bound['tangent'] / ms['tangent']:.1f} %), composed "
              f"{ms['composed tangent']:.3f} ms; primal {ms['primal']:.4f} "
              f"ms vs {bound['primal']:.4f} ms "
              f"({100 * bound['primal'] / ms['primal']:.1f} %); errors vs "
              f"the composed epilogue "
              f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}")
        row = {"name": "rt_epilogue", "route": "cuda",
               "source": PORT_KERNELS["rt_epilogue"][0],
               "replaces": PORT_KERNELS["rt_epilogue"][1],
               "launches": None, "max_abs_err": max_abs_err,
               "ms": ms["tangent"], "plain_ms": ms["composed tangent"],
               "bound_ms": bound["tangent"], "bound_by": "bytes",
               "library_ms": None}
        del prim, tan, I, dI
        gc.collect()
        torch.cuda.empty_cache()
    return row


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


def build_kernels() -> None:
    """Every kernel (``kernels.launch.KERNELS``) from the checkout's
    sources, one nvcc each, in parallel; prints each build's time and
    ptxas report."""
    from spectrobot_tpu_torch.kernels import build

    def one(name):
        t0 = time.time()
        path, log = build.build(name)
        return name, path, log, time.time() - t0

    names = list(launch.KERNELS)
    with ThreadPoolExecutor(len(names)) as pool:
        for name, path, log, secs in pool.map(one, names):
            print(f"build: {os.path.relpath(path, REPO)} in {secs:.2f} s")
            for line in log.splitlines():
                print(f"  nvcc {name}: {line}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Smoke run of the port on one "
                                            "CUDA GPU.")
    p.add_argument("--profiler-misses", type=int, default=0, metavar="ROUNDS",
                   help="in phase 6e, also measure how often a profiler "
                        "window misses the fused-halo kernel, with and "
                        "without its host wait (ROUNDS windows of each a "
                        "case)")
    args = p.parse_args(argv)
    # Phase 1: environment.
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from spectrobot_tpu_torch import adjoint, cli
    from spectrobot_tpu_torch.ops import cuda_basis as cb
    from spectrobot_tpu_torch.ops import cuda_basis_single as cbs
    from spectrobot_tpu_torch.ops import cuda_epilogue as ce
    from spectrobot_tpu_torch.ops import cuda_fma
    from spectrobot_tpu_torch.ops import cuda_opacity as co
    from spectrobot_tpu_torch.ops import cuda_single as cs
    from spectrobot_tpu_torch.ops import cuda_transpose as ctr
    from spectrobot_tpu_torch.parallel import cuda_dma as cd
    from spectrobot_tpu_torch.parallel import peer
    from spectrobot_tpu_torch.parallel.mesh import finalize_multihost

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
    build_kernels()
    for wrapper in (co, cb, ctr, cs, cbs, peer, cd, cuda_fma, ce):
        wrapper.KERNEL.library()

    # Phase 3: K1 against the plain version, and the tiers it exercised.
    tiers = {name: 0 for name in co.TIERS}
    rows = {}
    cases = {}
    for case in k1_cases(dev):
        counts = co.tier_counts(case.windows, case.nu_c, case.sx, case.y,
                                case.amps)
        print(f"tiers {case.name}: {json.dumps(counts)}")
        for k, v in counts.items():
            tiers[k] += v
        rows[case.name] = compare_k1(case)
        cases[case.name] = case
    check(all(v > 0 for v in tiers.values()),
          f"not every Voigt tier was exercised by K1: {tiers}")

    # Phase 4: K2 against the plain version (its tiers are K1's on the
    # same line states: the rows are amps-scaled, so the same states live).
    rows2, coeffs = {}, {}
    tiers2 = {name: 0 for name in co.TIERS}
    for seed, name in enumerate(("limb", "nadir+chi", "bench")):
        case = cases[name]
        coeffs[name] = coefficient_rows(case, K2_COLUMNS, seed)
        for k, v in co.tier_counts(case.windows, case.nu_c, case.sx,
                                   case.y, case.amps).items():
            tiers2[k] += v
        rows2[name] = compare_k2(case, coeffs[name])
    # The narrowest accumulator and the widest at K2's largest R (odd, so
    # its last n-tile is part padding) at the bench shape.
    for seed, R in ((3, 10), (4, cb.MAX_ROWS)):
        C = [c[:, :R].contiguous() for c in
             coefficient_rows(cases["bench"], (R + 1) // 2, seed)]
        rows2[f"bench, R = {R}"] = compare_k2(cases["bench"], C)
        del C
    print(f"K2 tiers over its cases: {json.dumps(tiers2)}")
    check(all(v > 0 for v in tiers2.values()),
          f"not every Voigt tier was exercised by K2: {tiers2}")

    # Phase 4b: K5 against the plain version (random cotangent rows: every
    # state live), the folded R = 66 case, and the adjoint identity.
    rows5, cots = {}, {}
    tiers5 = {name: 0 for name in co.TIERS}
    for seed, (name, R) in enumerate((("limb", 2), ("nadir+chi", 2),
                                      ("bench", 2), ("limb", 66))):
        case = cases[name]
        ct = cots[name, R] = cotangent_rows(case, R, 100 + seed)
        live = (ct != 0).flatten(1).any(1)[:, None]
        for k, v in co.tier_counts(case.windows, case.nu_c, case.sx, case.y,
                                   live).items():
            tiers5[k] += v
        rows5[name, R] = compare_k5(case, ct)
    print(f"K5 tiers over its cases: {json.dumps(tiers5)}")
    check(all(v > 0 for v in tiers5.values()),
          f"not every Voigt tier was exercised by K5: {tiers5}")
    adj_ratio = adjoint_identity(cases["limb"], coeffs["limb"],
                                 cots["limb", 66])

    # Phase 4c: K3 against the plain version, and the tiers over its cases.
    rows3, cases3 = {}, {}
    tiers3 = {name: 0 for name in co.TIERS}
    for case in k3_cases(cases, dev):
        counts = co.tier_counts(case.windows, *case.as_batch()[3:7])
        print(f"K3 tiers {case.name}: {json.dumps(counts)}")
        for k, v in counts.items():
            tiers3[k] += v
        rows3[case.name] = compare_k3(case)
        cases3[case.name] = case
    check(all(v > 0 for v in tiers3.values()),
          f"not every Voigt tier was exercised by K3: {tiers3}")

    # Phase 4d: the fused RT epilogue at the benchmark cells' shapes.
    epilogue = epilogue_phase(dev, card)

    # Phase 5: the main path, forward, through the CLI.
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        routes = epilogue_counts()
        cli.main(["forward", SCENE, "-o", f"run.output_dir={tmp}",
                  "--device", "cuda"])
        n = launch_counts()
        fwd_launches = (n["K1"], n["K2"], n["K5"], n["epilogue"])
        fwd_route = epilogue_route(routes)
        with np.load(os.path.join(tmp, "forward.npz")) as out:
            I, chans = out["values"], out["nu"]
    print(f"forward launches: K1 {fwd_launches[0]}, K2 {fwd_launches[1]}, "
          f"K5 {fwd_launches[2]}, epilogue {fwd_launches[3]} "
          f"({fwd_route} route)")
    check(fwd_launches[0] > 0, "the CLI forward never launched K1")
    check(fwd_route == "fused" and fwd_launches[3] == fwd_launches[0],
          f"the CLI forward's epilogue took the {fwd_route} route with "
          f"{fwd_launches[3]} launches, not one fused launch a K1")
    check(I.shape == (20, 96), f"radiance shape {I.shape} != (20, 96)")
    check(bool(np.isfinite(I).all() and (I >= 0).all()),
          "radiances not finite and non-negative")
    band = np.trapezoid(I, chans, axis=1)
    print(f"band radiance by tangent height: {band.tolist()}")
    check(bool(np.all(np.diff(band) < 0)),
          "band radiance does not fall with tangent height")
    cfg = cli.load_config(SCENE)
    scene = cli.build_scene(cfg, dev)
    I_plain = cli.run_forward(cfg, scene, cb.PLAIN)
    I_plain = I_plain.cpu().numpy()
    fwd_err = float(np.abs(I - I_plain).max())
    print(f"forward kernel vs plain: max |err| {fwd_err:.3e}, "
          f"max radiance {float(np.abs(I_plain).max()):.3e}")
    np.testing.assert_allclose(I, I_plain, rtol=1e-4,
                               atol=1e-5 * np.abs(I_plain).max())

    # Phase 6: the main path, retrieve, through the CLI.
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        routes = epilogue_counts()
        t0 = time.perf_counter()
        cli.main(["retrieve", SCENE, "-o", f"run.output_dir={tmp}",
                  "--device", "cuda"])
        torch.cuda.synchronize()
        ret_wall = time.perf_counter() - t0
        n = launch_counts()
        ret_launches = (n["K1"], n["K2"], n["K5"], n["epilogue"])
        ret_route = epilogue_route(routes)
        with np.load(os.path.join(tmp, "retrieval.npz")) as out:
            res = {k: out[k] for k in out.files}
        with open(os.path.join(tmp, "run.jsonl")) as f:
            log = [json.loads(line) for line in f]
    n_iter, chi2 = int(res["n_iter"]), float(res["chi2"])
    iters = [r for r in log if "chi2" in r]
    n_y = int(res["y_obs"].size)
    print(f"retrieve launches: K1 {ret_launches[0]}, K2 {ret_launches[1]}, "
          f"K5 {ret_launches[2]}, epilogue {ret_launches[3]} ({ret_route} "
          f"route; {n_iter} LM iterations)")
    print(f"retrieve: converged {bool(res['converged'])} "
          f"({res['stop_reason']}), chi2 {iters[0]['chi2']:.6g} at the "
          f"prior -> {chi2:.6g} over {n_y} measurements, "
          f"{res['x'].size} parameters")
    check(ret_launches[0] > 0, "the CLI retrieve never launched K1")
    check(ret_launches[1] == n_iter + 1,
          f"K2 launched {ret_launches[1]} times for {n_iter + 1} Jacobians")
    # One fused launch a forward (a K1 each) and two a Jacobian.
    check(ret_route == "fused"
          and ret_launches[3] == ret_launches[0] + n_iter + 1,
          f"the CLI retrieve's epilogue took the {ret_route} route with "
          f"{ret_launches[3]} launches, not {ret_launches[0] + n_iter + 1} "
          f"fused ones")
    epilogue["launches"] = ret_launches[3]
    check(bool(res["converged"]), "the retrieval did not converge")
    check(chi2 < iters[0]["chi2"], "chi2 did not fall")
    check(all(bool(np.isfinite(v).all()) for v in res.values()
              if v.dtype.kind == "f"), "retrieval.npz holds non-finite values")

    # The Jacobian at the prior, through the kernels and the plain engine.
    prob = {e.name: cli.retrieval_problem(cfg, scene, e)
            for e in (cb.KERNELS, cb.PLAIN)}
    n_x = int(prob["kernels"].x0.shape[0])
    jac = {name: cli.make_jacobian(cfg, p.fwd_flat, n_x, scene.nu.shape[0],
                                   dev)
           for name, p in prob.items()}
    x0 = prob["kernels"].x0
    reset_launches()
    jac_peak = peak_memory(lambda: jac["kernels"](x0))
    J = jac["kernels"](x0)
    n = launch_counts()
    check(jac_peak[2] == "fused" and n["epilogue"] == 2 * n["K2"] == 4,
          f"the Jacobian at the prior (eager and captured, then replayed) "
          f"took the {jac_peak[2]} epilogue route with launches "
          f"{json.dumps(n)}, not two fused launches a Jacobian")
    J_plain = jac["plain"](x0)
    jac_err = float((J - J_plain).abs().max())
    jac_max = float(J_plain.abs().max())
    print(f"Jacobian {tuple(J.shape)} kernels vs plain: max |err| "
          f"{jac_err:.3e} of max |K| {jac_max:.3e} "
          f"({jac_err / jac_max:.3e}); peak device memory {jac_peak[0]:.2f} "
          f"GB ({jac_peak[1]:.2f} GB resident before it)")
    check(bool(torch.isfinite(J).all()), "non-finite Jacobian")
    check(jac_err <= K2_REL * jac_max,
          "the kernel Jacobian disagrees with the plain one")

    # The CLI forward and retrieve again with the chi wing correction.
    chi_cli = ["-o", "lines.chi=co2_mars", "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        for cmd in ("forward", "retrieve"):
            cli.main([cmd, SCENE, "-o", f"run.output_dir={tmp}", *chi_cli])
        n = launch_counts()
        with np.load(os.path.join(tmp, "forward.npz")) as out:
            I_chi = out["values"]
        with np.load(os.path.join(tmp, "retrieval.npz")) as out:
            chi_res = {k: out[k] for k in ("converged", "n_iter", "chi2")}
    cfg_chi = cli.load_config(SCENE, {"lines.chi": "co2_mars"})
    I_chi_plain = cli.run_forward(cfg_chi, cli.build_scene(cfg_chi, dev),
                                  cb.PLAIN).cpu().numpy()
    print(f"CLI with lines.chi = co2_mars: launches {json.dumps(n)}; "
          f"forward vs plain max |err| {np.abs(I_chi - I_chi_plain).max():.3e}"
          f", vs no chi max |diff| {np.abs(I_chi - I).max():.3e} of max "
          f"{np.abs(I).max():.3e}; retrieve converged "
          f"{bool(chi_res['converged'])}, {int(chi_res['n_iter'])} LM "
          f"iterations, chi2 {float(chi_res['chi2']):.6g}")
    check(n["K1"] > 0 and n["K2"] == int(chi_res["n_iter"]) + 1,
          "the CLI with chi did not run K1 and one K2 per Jacobian")
    check(bool(np.isfinite(I_chi).all() and (I_chi >= 0).all()),
          "chi radiances not finite and non-negative")
    np.testing.assert_allclose(I_chi, I_chi_plain, rtol=1e-4,
                               atol=1e-5 * np.abs(I_chi_plain).max())
    check(bool(chi_res["converged"]), "the retrieval with chi did not "
                                      "converge")

    # Phase 6b: the main path in reverse mode, the gradient of the
    # retrieval cost at the prior (the retrieve's observations and noise).
    y_obs = torch.as_tensor(res["y_obs"].reshape(-1), dtype=torch.float32,
                            device=dev)
    sigma = torch.as_tensor(res["noise"].reshape(-1), dtype=torch.float32,
                            device=dev)
    rev = {e.name: cli.retrieval_problem(cfg, scene, e, analytic_jvp="rev")
           for e in (cb.KERNELS, cb.PLAIN)}

    def cost_grad(p):
        x = p.x0.detach().clone().requires_grad_()
        r = (p.fwd_flat(x) - y_obs) / sigma
        return torch.autograd.grad(0.5 * torch.sum(r * r), x)[0]

    reset_launches()
    g_rev = cost_grad(rev["kernels"])
    torch.cuda.synchronize()
    n = launch_counts()
    grad_launches = (n["K1"], n["K2"], n["K5"])
    g_plain = cost_grad(rev["plain"])
    y0 = prob["kernels"].fwd_flat(x0)
    g_jac = J.T @ ((y0 - y_obs) / sigma ** 2)
    g_max = float(g_jac.abs().max())
    errs = {}
    for name, ref in (("J^T dL/dy", g_jac), ("plain reverse", g_plain)):
        err = (g_rev - ref).abs()
        errs[name] = float(err.max())
        ok = bool(torch.all(err <= GRAD_RTOL * ref.abs()
                            + GRAD_ATOL_REL * g_max))
        print(f"reverse gradient vs {name}: max |err| {errs[name]:.3e} of "
              f"max |g| {g_max:.3e} (budget {GRAD_RTOL:g}*|ref| + "
              f"{GRAD_ATOL_REL:g}*max|g|): {'ok' if ok else 'FAILED'}")
        check(ok, f"the reverse gradient disagrees with {name}")
    print(f"reverse gradient launches: K1 {grad_launches[0]}, K2 "
          f"{grad_launches[1]}, K5 {grad_launches[2]} ({n_x} parameters)")
    check(grad_launches == (1, 0, 1),
          f"the reverse gradient launched (K1, K2, K5) = {grad_launches}, "
          f"not (1, 0, 1)")
    check(bool(torch.isfinite(g_rev).all()), "non-finite reverse gradient")
    # Which states K5 evaluates on this path: those with nonzero cotangent
    # rows (an engine that records them; its launches are not counted).
    seen = {}
    cost_grad(cli.retrieval_problem(cfg, scene, recording_engine_rows(seen),
                                    analytic_jvp="rev"))
    seen["live"] = seen["ct"].flatten(1).ne(0).any(1)
    amps_dead = ~cases["limb"].amps.flatten(1).ne(0).any(1)
    print(f"reverse gradient: K5 cotangent rows nonzero in "
          f"{int(seen['live'].sum())} of {seen['live'].numel()} states, "
          f"{int((seen['live'] & amps_dead).sum())} of them with zero "
          f"amplitudes ({int(amps_dead.sum())} zero-amplitude states)")

    # The adjoint tool at its defaults.
    adj = adjoint.run(dev)
    check(all(bool(np.isfinite(leg["grad"]).all())
              for leg in adj["legs"].values()), "adjoint: non-finite grad")
    check(adj["max_rel_grad_diff"] <= 1e-4,
          f"adjoint: analytic and plain-AD gradients differ by "
          f"{adj['max_rel_grad_diff']:.3e} of max |g|")

    # Phase 6c: the mesh at world size 1 (NCCL, in-process).
    mesh = mesh_phase(cfg, scene, prob["kernels"], x0, J, y_obs, sigma,
                      cases3["bench state"], bench_device_lines(dev).nu0,
                      card)

    # Phase 6d: the single-state line sum (K3, K4; K1, K2 and K5 on its
    # structural and reverse routes).
    single = single_state_phase(dev, cases3, scene)

    # Phase 6e: the remote-copy halo tier on the loopback ring.
    dma = dma_phase(dev, cases3["bench state"], bench_device_lines(dev).nu0,
                    cases3["dense"], miss_rounds=args.profiler_misses)

    # Phase 6f: acceptance config 3 and the composed features.
    c3 = config3_phase(dev, mesh["mesh"])

    # Phase 6g: the (P, T) table tier and the 2-D climatology.
    tables = lut_phase(dev, mesh["mesh"], {
        "LTE": {"I": I, "J": J, "jac_peak": jac_peak},
        "non-LTE": {k: c3[k] for k in ("I", "J", "jac_peak")}})

    # Phase 6h: the Weideman evaluator, run.save_optics and the profiling
    # utilities.
    weid = weideman_phase(dev, cfg, scene, I, J, card)

    # Phase 6k: K2 past its row limit, config 5 and the memory guard.
    k2_rows_phase(cases, card)
    c5 = config5_phase(dev, card)
    guard_phase(dev, card, {
        "slice": (cfg, n_x, jac_peak),
        "config 3": (cli.load_config(SCENE, CONFIG3_CLI), n_x, c3["jac_peak"]),
        "composed": (cli.load_config(SCENE, COMPOSED_CLI), n_x,
                     c3["composed_jac_peak"]),
        "Weideman float64 slice": (cli.load_config(SCENE, WEIDEMAN_CLI), n_x,
                                   weid["jac_peak"])}, c5)
    # Phase 6l: float64 through the float32 kernels, and
    # compute.use_pallas = false through the plain engine.
    release_cache("phase 6l")
    engine_dtype_phase(dev, mesh["mesh"], cfg, scene, I, J, card)
    # Release the allocator's cache (phase 6f's composed Jacobian alone
    # peaks near 25 GB): phases 7 and 6i time each call's own allocations,
    # not the allocator freeing and retrying on a full device.
    release_cache("the timings")

    # Phase 7: timings.
    def k1(case, fn):
        return lambda: fn(case.nu, case.windows, case.nu_c, case.sx,
                          case.y, case.amps, chi_b=case.chi_b)

    def k2(case, fn):
        return lambda: fn(case.nu, case.windows, case.nu_c, case.sx,
                          case.y, *coeffs[case.name], chi_b=case.chi_b)

    times = {}
    for name in ("limb", "bench"):
        c = cases[name]
        times["K1", name] = (cuda_ms(k1(c, co.accumulate_batch)),
                             cuda_ms(k1(c, cb.PLAIN.accumulate)))
        print(f"time K1 {name} [{card}]: kernel {times['K1', name][0]:.3f} "
              f"ms, plain {times['K1', name][1]:.3f} ms "
              f"({c.nu_c.shape[0]} states x {c.nu_c.shape[1]} lines x "
              f"{c.nu.shape[0]} points)")
    c = cases["limb"]
    times["K2", "limb"] = (cuda_ms(k2(c, cb.basis_contract_batch)),
                           cuda_ms(k2(c, cb.PLAIN.contract)))
    print(f"time K2 limb [{card}]: kernel {times['K2', 'limb'][0]:.3f} ms, "
          f"plain {times['K2', 'limb'][1]:.3f} ms ({c.nu_c.shape[0]} states "
          f"x {c.nu_c.shape[1]} lines x {c.nu.shape[0]} points x "
          f"{2 * K2_COLUMNS} rows)")
    c = cases["bench"]
    k2_bench = cuda_ms(k2(c, cb.basis_contract_batch))
    print(f"time K2 bench [{card}]: kernel {k2_bench:.3f} ms "
          f"({c.nu_c.shape[0]} states x {c.nu_c.shape[1]} lines x "
          f"{c.nu.shape[0]} points x {2 * K2_COLUMNS} rows)")
    def k5(case, fn, R):
        return lambda: fn(case.nu, case.windows, case.nu_c, case.sx, case.y,
                          cots[case.name, R], chi_b=case.chi_b)

    c = cases["limb"]
    times["K5", "limb"] = (cuda_ms(k5(c, ctr.basis_transpose_batch, 2)),
                           cuda_ms(k5(c, cb.PLAIN.transpose, 2)))
    k5_66 = cuda_ms(k5(c, ctr.basis_transpose_batch, 66))
    k5_bench = cuda_ms(k5(cases["bench"], ctr.basis_transpose_batch, 2))
    print(f"time K5 limb [{card}]: kernel {times['K5', 'limb'][0]:.3f} ms, "
          f"plain {times['K5', 'limb'][1]:.3f} ms ({c.nu_c.shape[0]} states "
          f"x {c.nu_c.shape[1]} lines x {c.nu.shape[0]} points x 2 rows); "
          f"R = 66: {k5_66:.3f} ms; bench (R = 2, "
          f"{cases['bench'].nu_c.shape[0]} states x "
          f"{cases['bench'].nu_c.shape[1]} lines): {k5_bench:.3f} ms")
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        cli.run_forward(cfg, scene, cb.KERNELS)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"warm forward wall [{card}]: {1e3 * np.median(walls[1:]):.2f} ms "
          f"(median of 3 after a warm-up; examples/mars_limb.toml)")
    fwd_ms = cuda_ms(lambda: prob["kernels"].fwd_flat(x0))
    jac_ms = cuda_ms(lambda: jac["kernels"](x0))
    print(f"time warm forward [{card}]: {fwd_ms:.2f} ms; warm Jacobian "
          f"({n_x} columns): {jac_ms:.2f} ms (examples/mars_limb.toml, "
          f"the retrieval's flat forward)")
    grad_ms = cuda_ms(lambda: cost_grad(rev["kernels"]))
    print(f"time warm reverse gradient [{card}]: {grad_ms:.2f} ms (the "
          f"retrieval cost over {n_x} parameters, one K1 and one K5 call)")
    it_walls = [r["wall_s"] for r in iters]
    print(f"time retrieve [{card}]: {ret_wall:.2f} s wall ({n_iter} LM "
          f"iterations, first call of the process), per-iteration median "
          f"{1e3 * np.median(it_walls):.2f} ms")

    # K3 and its plain version on the bench state and the dense shape, and
    # their bounds (the pairs of the one state, n_out rows of FMAs).
    def k3(case, fn):
        return lambda: fn(case.nu, case.windows, case.nu_c, case.sx, case.y,
                          case.amps, cutoff_cm1=case.windows.cutoff_cm1,
                          chi_b=case.chi_b)

    def plain3(nu, windows, *args, **kw):
        return cs.accumulate_single_plain(nu, *args, **kw)

    k3_bounds = {}
    for name in ("bench state", "dense"):
        c = cases3[name]
        L, P, n_out = c.nu_c.shape[0], c.nu.shape[0], c.amps.shape[0]
        times["K3", name] = (cuda_ms(k3(c, cs.accumulate_single)),
                             cuda_ms(k3(c, plain3)))
        pairs = case_region_counts(c.as_batch(), torch.ones(
            1, dtype=torch.bool, device=dev))
        k3_bounds[name] = bound_ms(pairs, REGION_FLOPS, 4.0 + 2 * n_out,
                                   4.0 * (P + 3 * L + n_out * (L + P)))
        print(f"time K3 {name} [{card}]: kernel {times['K3', name][0]:.3f} "
              f"ms, plain {times['K3', name][1]:.3f} ms ({L} lines x {P} "
              f"points x {n_out} rows, segments {cs.segments(c.windows)}); "
              f"in-cutoff pairs by region {json.dumps(pairs)}; bound "
              f"{k3_bounds[name][0]:.4f} ms ({k3_bounds[name][1]}); "
              f"{sum(pairs.values()) / (times['K3', name][0] / 1e3):.4g} "
              f"pairs/s")
    # K4 and its plain version on its cases, and their bounds (the pairs
    # of the one state, 4R contraction FMAs each).
    def k4(case, fn):
        return lambda: fn(case.nu, case.windows, case.nu_c, case.sx, case.y,
                          *case.C, cutoff_cm1=case.windows.cutoff_cm1,
                          chi_b=case.chi_b)

    def plain4(nu, windows, *args, **kw):
        return cbs.basis_contract_single_plain(nu, *args, **kw)

    k4_bounds = {}
    for name, c in single["cases"].items():
        L, P, R = c.nu_c.shape[0], c.nu.shape[0], c.C[0].shape[0]
        times["K4", name] = (cuda_ms(k4(c, cbs.basis_contract_single)),
                             cuda_ms(k4(c, plain4)))
        pairs = case_region_counts(c.as_batch(), torch.ones(
            1, dtype=torch.bool, device=dev))
        n_bytes = 4.0 * (P + 3 * L + 4 * R * L + R * P
                         + (0 if c.chi_b is None else L))
        k4_bounds[name] = basis_bound_ms(pairs, R, n_bytes)
        fp32_bound = bound_ms(pairs, REGION_FLOPS_GRAD, 4.0 + 8 * R, n_bytes)
        print(f"time K4 {name} [{card}]: kernel {times['K4', name][0]:.3f} "
              f"ms, plain {times['K4', name][1]:.3f} ms ({L} lines x {P} "
              f"points x {R} rows, segments {cs.segments(c.windows)}, row "
              f"groups {cbs.row_groups(R)[0]}); in-cutoff pairs by region "
              f"{json.dumps(pairs)}; bound {k4_bounds[name][0]:.4f} ms "
              f"({k4_bounds[name][2]}); FP32-core bound "
              f"{fp32_bound[0]:.4f} ms; "
              f"{sum(pairs.values()) / (times['K4', name][0] / 1e3):.4g} "
              f"pairs/s")
    print(f"time config-1 Jacobian [{card}]: {single['config1_jac_ms']:.3f} "
          f"ms (torch.func.jacfwd of nadir_single_layer over its 5 scalars, "
          f"CUDA events, median of 5: the window table on the host, one K3 "
          f"and one K4 call)")
    f, nu_b, mine = mesh["halo"]
    halo_ms = cuda_ms(lambda: f(nu_b, mine))
    # The host dispatches a forward's ~300 small kernels, so its time varies
    # with the host: the three forwards are timed in turns, 3 rounds.
    fwds = {"single-device": lambda: cli.run_forward(cfg, scene, cb.KERNELS),
            **{f"{tier} tier": (lambda oe: lambda: oe.forward_flat(
                mesh["x_empty"]))(mesh[f"fwd_{tier}"])
               for tier in ("psum", "nu-halo")}}
    rounds = {name: [] for name in fwds}
    for order in (list(fwds), list(fwds)[::-1], list(fwds)):
        for name in order:
            rounds[name].append(cuda_ms(fwds[name]))
    for name, t in rounds.items():
        print(f"time warm forward, {name} [{card}]: {np.median(t):.2f} ms "
              f"(median of 3 rounds: {', '.join(f'{v:.2f}' for v in t)}; "
              f"examples/mars_limb.toml, the (1, 1, 1) mesh for the tiers)")
    print(f"time halo accumulation of the bench state [{card}]: "
          f"{halo_ms:.3f} ms (one K3 call)")
    walls3 = []
    for _ in range(4):
        t0 = time.perf_counter()
        cli.run_forward(c3["cfg"], c3["scene"], cb.KERNELS)
        torch.cuda.synchronize()
        walls3.append(time.perf_counter() - t0)
    jac3_ms = cuda_ms(lambda: c3["jac"](c3["x0"]))
    print(f"time config 3 [{card}]: warm forward wall "
          f"{1e3 * np.median(walls3[1:]):.2f} ms (median of 3 after a "
          f"warm-up, cli.run_forward); warm Jacobian ({c3['n_x']} columns) "
          f"{jac3_ms:.2f} ms (CUDA events, median of 5); retrieve "
          f"per-iteration median {1e3 * np.median(c3['iter_walls']):.2f} ms "
          f"({len(c3['iter_walls'])} LM iterations, run.jsonl)")
    # K1, K2 and K5 on config 3's own inputs, and their bounds (K1 and K2
    # over the amplitude-live states, K5 over the cotangent-live ones).
    c = c3["case"]
    B3, L3, P3 = c.nu_c.shape[0], c.nu_c.shape[1], c.nu.shape[0]
    R3 = c3["C"][0].shape[1]
    lines3 = 4.0 * (P3 + 3 * B3 * L3)
    t3 = {"K1": (cuda_ms(k1(c, co.accumulate_batch)),
                 cuda_ms(k1(c, cb.PLAIN.accumulate))),
          "K2": (cuda_ms(lambda: cb.basis_contract_batch(
              c.nu, c.windows, c.nu_c, c.sx, c.y, *c3["C"])),),
          "K5": (cuda_ms(lambda: ctr.basis_transpose_batch(
              c.nu, c.windows, c.nu_c, c.sx, c.y, c3["ct"])),)}
    p1 = case_region_counts(c, c.amps.flatten(1).ne(0).any(1))
    p5 = case_region_counts(c, c3["ct"].flatten(1).ne(0).any(1))
    b3 = {"K1": bound_ms(p1, REGION_FLOPS, 4.0 + 2 * 2, lines3 + 4.0 * (
              2 * B3 * L3 + 2 * B3 * P3)),
          "K2": basis_bound_ms(p1, R3, basis_batch_bytes(B3, L3, P3, R3)),
          "K5": bound_ms(p5, REGION_FLOPS_GRAD, 4.0 + 8 * 2, lines3 + 4.0 * (
              B3 * 2 * P3 + 4 * B3 * 2 * L3))}
    print(f"time config 3 kernels [{card}] ({B3} states x {L3} lines x "
          f"{P3} points; K2 at R = {R3}, K5 at R = 2): K1 "
          f"{t3['K1'][0]:.3f} ms (plain {t3['K1'][1]:.3f}) vs "
          f"{b3['K1'][0]:.4f} ms; K2 {t3['K2'][0]:.3f} ms vs "
          f"{b3['K2'][0]:.4f} ms ({b3['K2'][2]}); K5 {t3['K5'][0]:.3f} ms "
          f"vs {b3['K5'][0]:.4f} ms; in-cutoff pairs by region: K1/K2 "
          f"{json.dumps(p1)}, K5 {json.dumps(p5)}")
    # The table tier: each build (its K1 call's share) beside the plain
    # build, and the forward wall, Jacobian and LM iteration through the
    # table beside the direct ones (the forwards timed in turns).
    direct = {"LTE": (lambda: cli.run_forward(cfg, scene, cb.KERNELS),
                      jac_ms, it_walls, jac_peak),
              "non-LTE": (lambda: cli.run_forward(c3["cfg"], c3["scene"],
                                                  cb.KERNELS),
                          jac3_ms, c3["iter_walls"], c3["jac_peak"])}
    for tier, t in tables.items():
        build_ms = cuda_ms(lambda: t["build"](*t["args"], **t["lattice"]))
        k1_ms = cuda_ms(k1(t["k1"], co.accumulate_batch))
        fwd_dir, jac_dir_ms, walls_dir, peak_dir = direct[tier]
        fwd_lut = lambda: cli.run_forward(t["cfg"], t["scene"], cb.KERNELS)
        fw = {"table": [], "direct": []}
        for _ in range(2):
            fw["table"].append(wall_ms(fwd_lut))
            fw["direct"].append(wall_ms(fwd_dir))
        jac_lut_ms = cuda_ms(lambda: t["jac"](t["x0"]))
        B, L = t["k1"].nu_c.shape
        print(f"time {tier} table [{card}]: build {build_ms:.3f} ms (CUDA "
              f"events, median of 5), of which its one K1 call "
              f"{k1_ms:.3f} ms ({100 * k1_ms / build_ms:.1f} %; {B} states "
              f"x {L} lines x {t['k1'].nu.shape[0]} points); plain build "
              f"{1e3 * t['plain_s']:.1f} ms (one run, host clock)")
        print(f"time {tier} table vs direct [{card}]: warm forward wall "
              f"{np.median(fw['table']):.2f} vs {np.median(fw['direct']):.2f}"
              f" ms (cli.run_forward, median of 3 after a warm-up, 2 rounds "
              f"in turns: table {', '.join(f'{v:.2f}' for v in fw['table'])}"
              f", direct {', '.join(f'{v:.2f}' for v in fw['direct'])}); "
              f"Jacobian {jac_lut_ms:.2f} vs "
              f"{jac_dir_ms:.2f} ms (CUDA events, median of 5), peak device "
              f"memory {t['jac_peak'][0]:.2f} vs "
              f"{peak_dir[0]:.2f} GB; LM "
              f"iteration median {1e3 * np.median(t['iter_walls']):.2f} vs "
              f"{1e3 * np.median(walls_dir):.2f} ms (run.jsonl)")

    # Phase 6i: the measurement tools at the reference's TPU sizes, after
    # phase 7's timings (its FMA chains at full load and its plain scenes
    # stay out of them), on phase 6c's process group.
    release_cache("the tools")
    tools = tools_phase(dev, mesh["mesh"], card)
    # Phase 6j: the nu-halo forward's exchange schedule on the same group.
    halo_overlap_phase(dev, cfg, scene, mesh, card)
    finalize_multihost()

    # Each kernel's bound at its timed limb inputs: K1 and K2 over the
    # amplitude-live states, K5 over the cotangent-live ones (all of them).
    c = cases["limb"]
    B, L, P = c.nu_c.shape[0], c.nu_c.shape[1], c.nu.shape[0]
    lines_in = 4.0 * (P + 3 * B * L)                 # nu; nu_c, sx, y
    amps_live = c.amps.flatten(1).ne(0).any(1)
    k1_pairs = case_region_counts(c, amps_live)
    k5_pairs = case_region_counts(c,
                                  cots["limb", 2].flatten(1).ne(0).any(1))
    R2 = 2 * K2_COLUMNS
    bounds = {
        "opacity_batch": bound_ms(k1_pairs, REGION_FLOPS, 4.0 + 2 * 2,
                                  lines_in + 4.0 * (2 * B * L + 2 * B * P)),
        "basis_batch": basis_bound_ms(k1_pairs, R2,
                                      basis_batch_bytes(B, L, P, R2)),
        "basis_transpose": bound_ms(k5_pairs, REGION_FLOPS_GRAD,
                                    4.0 + 8 * 2,
                                    lines_in + 4.0 * (B * 2 * P
                                                      + 4 * B * 2 * L)),
        "opacity_single": k3_bounds["bench state"],
        "basis_single": k4_bounds["dense, R = 6"],
        **dma["bounds"],
    }
    k2_fp32 = bound_ms(k1_pairs, REGION_FLOPS_GRAD, 4.0 + 8 * R2,
                       basis_batch_bytes(B, L, P, R2))
    print(f"K2 (limb, R = {R2}) bound {bounds['basis_batch'][0]:.4f} ms "
          f"({bounds['basis_batch'][2]}); FP32-core bound "
          f"{k2_fp32[0]:.4f} ms; K4 (dense, R = 6) bound "
          f"{bounds['basis_single'][0]:.4f} ms "
          f"({bounds['basis_single'][2]})")
    print(f"in-cutoff pairs by region (limb): K1/K2 {json.dumps(k1_pairs)}, "
          f"K5 {json.dumps(k5_pairs)}; bounds [ms]: "
          f"{json.dumps({k: v[0] for k, v in bounds.items()})}")
    k5_66_bound = bound_ms(k5_pairs, REGION_FLOPS_GRAD, 4.0 + 8 * R2,
                           lines_in + 4.0 * (B * R2 * P + 4 * B * R2 * L))
    # The same bounds at the bench scale, beside the bench times.
    c = cases["bench"]
    Bb, Lb, Pb = c.nu_c.shape[0], c.nu_c.shape[1], c.nu.shape[0]
    lines_b = 4.0 * (Pb + 3 * Bb * Lb)
    k1b_pairs = case_region_counts(c, c.amps.flatten(1).ne(0).any(1))
    k5b_pairs = case_region_counts(c,
                                   cots["bench", 2].flatten(1).ne(0).any(1))
    k1b = bound_ms(k1b_pairs, REGION_FLOPS, 4.0 + 2 * 2,
                   lines_b + 4.0 * (2 * Bb * Lb + 2 * Bb * Pb))
    k5b = bound_ms(k5b_pairs, REGION_FLOPS_GRAD, 4.0 + 8 * 2,
                   lines_b + 4.0 * (Bb * 2 * Pb + 4 * Bb * 2 * Lb))
    print(f"bounds beside the times [{card}]: K1 limb "
          f"{times['K1', 'limb'][0]:.3f} ms vs {bounds['opacity_batch'][0]:.4f}"
          f" ms; K1 bench {times['K1', 'bench'][0]:.3f} ms vs {k1b[0]:.4f} "
          f"ms ({k1b[1]}); K5 limb R = 2 {times['K5', 'limb'][0]:.3f} ms vs "
          f"{bounds['basis_transpose'][0]:.4f} ms; K5 limb R = {R2} "
          f"{k5_66:.3f} ms vs {k5_66_bound[0]:.4f} ms ({k5_66_bound[1]}); "
          f"K5 bench R = 2 {k5_bench:.3f} ms vs {k5b[0]:.4f} ms ({k5b[1]}); "
          f"in-cutoff pairs by region (bench): K1 {json.dumps(k1b_pairs)}, "
          f"K5 {json.dumps(k5b_pairs)}")
    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches,
         "max_abs_err": row["max_abs_err"], "ms": t[0], "plain_ms": t[1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": t[2] if len(t) > 2 else None}
        for name, launches, row, t in (
            ("opacity_batch", ret_launches[0], rows["limb"],
             times["K1", "limb"]),
            ("basis_batch", ret_launches[1], rows2["limb"],
             times["K2", "limb"]),
            ("basis_transpose", grad_launches[2], rows5["limb", 2],
             times["K5", "limb"]),
            ("opacity_single", mesh["k3_launches"], rows3["bench state"],
             times["K3", "bench state"]),
            ("basis_single", single["config1_jac_launches"],
             single["rows"]["dense, R = 6"], times["K4", "dense, R = 6"]),
            ("dma_ring", dma["launches"]["dma_ring"],
             {"max_abs_err": dma["ring_err"]}, dma["times"]["dma_ring"]),
            ("dma_halo", dma["launches"]["dma_halo"],
             dma["rows"]["dense", 4, 10.0], dma["times"]["dma_halo"]))],
        "measurement_kernels": [
            {"name": "fma_peak", "route": "cuda",
             "source": MEASUREMENT_KERNELS["fma_peak"][0],
             "replaces": MEASUREMENT_KERNELS["fma_peak"][1],
             "launches": tools["fma"]["launches"],
             "max_abs_err": tools["fma"]["max_abs_err"],
             "ms": tools["fma"]["ms"], "plain_ms": tools["fma"]["plain_ms"],
             "bound_ms": tools["fma"]["bound"][0],
             "bound_by": tools["fma"]["bound"][1], "library_ms": None}],
        "port_kernels": [epilogue]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
