"""The least time an H100 could take for a line sum: the work the inputs
require, counted by Humlicek region, over the card's peak rates.

A frozen copy of the port's ``spectrobot_tpu_torch/roofline.py`` (the
region counts, the operation and byte counts and the bounds), kept with
the benchmark so that a later change to the program cannot move the
yardstick.  ``tests/test_spectrobench_yardstick.py`` holds it to the
port's functions on small inputs.

The count is of the required work, not of what any one kernel executes:
every (point, line) pair within the cutoff of a live state evaluates the
one Humlicek region its (x, y) lies in.  A region's cost is the step
between consecutive tiers of the reference's per-pair audit (far 14, mid
55, near3 165, near4 300 flops and 30, 80, 360, 550 for the basis; one
transcendental = 8 flops), plus 4 pipeline flops a pair (dnu, x,
broadcast, mask) and 2 per FMA of a contraction against amplitude or
coefficient rows.

Rates: NVIDIA's H100 SXM data sheet (67 TFLOP/s FP32 on the CUDA cores,
495 TFLOP/s dense TF32 on the tensor cores, 3.35 TB/s of HBM3), which
assume the card's full 700 W power limit.  K2 contracts on the tensor
cores in three TF32 passes (3xTF32), so its bound is the largest of the
basis flops over the FP32 rate, the contraction's flops times
``TF32_PASSES`` over the TF32 rate, and the bytes over the memory rate.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

REGIONS = ("I", "II", "III", "IV")
REGION_FLOPS = dict(zip(REGIONS, (14.0, 41.0, 110.0, 135.0)))
REGION_FLOPS_GRAD = dict(zip(REGIONS, (30.0, 50.0, 280.0, 190.0)))
FP32_FLOPS, TF32_FLOPS, HBM_BYTES_S = 67e12, 495e12, 3.35e12
TF32_PASSES = 3
PIPELINE_FLOPS = 4.0
# Pairs counted in one step of region_counts: bounds its temporaries.
PAIRS_PER_STEP = 1 << 25


def region_counts(nu: torch.Tensor, nu_c: torch.Tensor, sx: torch.Tensor,
                  y: torch.Tensor, live: torch.Tensor,
                  cutoff_cm1: Optional[float]) -> dict:
    """The (point, line) pairs within ``cutoff_cm1`` (None: every pair) of
    the ``live`` states [B] (bool) of a line sum on the grid ``nu`` [P]
    with lines ``nu_c``, ``sx``, ``y`` [B, L], by the Humlicek region their
    (x, y) lies in (s = |x| + y: I s >= 15, II s >= 5.5, IV y < 0.195 |x| -
    0.176, else III), counted on the tensors' device in steps of at most
    ``PAIRS_PER_STEP`` pairs."""
    cut = math.inf if cutoff_cm1 is None else cutoff_cm1
    L, P = nu_c.shape[-1], nu.shape[0]
    n = torch.zeros(4, dtype=torch.int64, device=nu.device)
    lines = max(1, min(L, PAIRS_PER_STEP // P))
    states = max(1, PAIRS_PER_STEP // (lines * P))
    for g in torch.nonzero(live)[:, 0].split(states):
        for s in range(0, L, lines):
            part = slice(s, s + lines)
            dnu = nu[None, None, :] - nu_c[g, part][:, :, None]
            x = (dnu * sx[g, part][:, :, None]).abs()
            yy = y[g, part][:, :, None].expand_as(x)
            s_ = x + yy
            inside = dnu.abs() <= cut
            r1, r2 = s_ >= 15.0, (s_ >= 5.5) & (s_ < 15.0)
            r4 = (s_ < 5.5) & (yy < 0.195 * x - 0.176)
            r3 = (s_ < 5.5) & ~r4
            n += torch.stack([(r & inside).sum() for r in (r1, r2, r3, r4)])
    return dict(zip(REGIONS, (int(v) for v in n.cpu())))


def operations(pairs: dict, flops: dict, per_pair: float) -> float:
    """The flops of the pairs: by region, plus ``per_pair`` flops each."""
    return sum(n * (flops[r] + per_pair) for r, n in pairs.items())


def bound_ms(pairs: dict, flops: dict, per_pair: float,
             n_bytes: float) -> tuple:
    """(bound in ms, what bounds it): the larger of the pairs' flops (by
    region, plus ``per_pair`` flops each) over the FP32 rate and ``n_bytes``
    over the memory rate."""
    t_ops = operations(pairs, flops, per_pair) / FP32_FLOPS
    t_bytes = n_bytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def basis_bound_ms(pairs: dict, R: int, n_bytes: float) -> tuple:
    """(bound in ms, what bounds it, which term) of K2 at ``R`` rows: the
    largest of the basis's flops over the FP32 rate, the contraction's
    TF32_PASSES passes over the TF32 rate, and ``n_bytes`` over the memory
    rate."""
    n = sum(pairs.values())
    terms = {
        "FP32 basis": operations(pairs, REGION_FLOPS_GRAD,
                                 PIPELINE_FLOPS) / FP32_FLOPS,
        "TF32 contraction": TF32_PASSES * n * 8.0 * R / TF32_FLOPS,
        "bytes": n_bytes / HBM_BYTES_S}
    term = max(terms, key=terms.get)
    return (1e3 * terms[term], "bytes" if term == "bytes" else "operations",
            term)


def basis_batch_bytes(B: int, L: int, P: int, R: int) -> float:
    """K2's bytes at B states, L lines, P points and R rows: the grid and
    the lines' (nu_c, sx, y) read once, four coefficient rows [B, R, L]
    read once, the [B, R, P] output written once (float32)."""
    return 4.0 * (P + 3 * B * L + 4 * B * R * L + B * R * P)


def line_sum_bytes(B: int, L: int, P: int, n_out: int = 2) -> float:
    """K1's bytes at B states, L lines and P points with ``n_out``
    amplitude rows (float32): the grid and the lines' (nu_c, sx, y) read
    once, the rows [B, n_out, L] read once, the [B, n_out, P] output
    written once (the port's chip_smoke counts the same)."""
    return 4.0 * (P + 3 * B * L) + 4.0 * (n_out * B * L + n_out * B * P)


def k1_bound_ms(pairs: dict, B: int, L: int, P: int, n_out: int = 2
                ) -> float:
    """K1's bound [ms]: the pairs' primal flops (by region, the pipeline
    and 2 per amplitude row) or its bytes, whichever is larger."""
    return bound_ms(pairs, REGION_FLOPS, PIPELINE_FLOPS + 2.0 * n_out,
                    line_sum_bytes(B, L, P, n_out))[0]


def k2_bound_ms(pairs: dict, B: int, L: int, P: int, R: int) -> float:
    """K2's bound [ms] at ``R`` coefficient rows (:func:`basis_bound_ms`)."""
    return basis_bound_ms(pairs, R, basis_batch_bytes(B, L, P, R))[0]
