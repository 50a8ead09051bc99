"""An empirical FP32 FMA ceiling of the card: the wrapper of the measurement
kernel ``csrc/fma_peak.cu`` and its plain PyTorch version.

No TPU kernel is replaced: the reference bench measures its chip's
elementwise ceiling with K-deep chains ``x = x * a + b`` that XLA fuses
into one kernel (``bench.py:bench_roofline``).  Eager PyTorch runs each
link as a pass over memory, which measures the memory rate, so the chain
runs in registers in a hand-written kernel: ``out = f^depth(x)`` with
``f(v) = fma(v, a, b)``, four independent chains a thread
(``spectrobot_tpu_torch.bench.bench_roofline`` takes the largest rate over
depths 64 and 256).

Device rule: a CPU tensor goes to :func:`fma_chain_plain`; a CUDA tensor
always launches the kernel, and a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from spectrobot_tpu_torch.kernels import launch

# The chain depths the kernel is built for (csrc/fma_peak.cu).
DEPTHS = (8, 64, 256)

# The kernel, bound at its first launch (``kernels.launch``).
KERNEL = launch.Kernel(
    "fma_peak", [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_float, ctypes.c_float, ctypes.c_longlong,
                 ctypes.c_int, ctypes.c_void_p])


def _fmaf(x: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """fmaf(x, a, b) on every element of the float32 tensor ``x`` (float32
    ``a`` and ``b``), rounded once as the card's FMA rounds: the product
    is exact in float64 (24 x 24 bits), the sum is rounded to odd in
    float64 (the nearest-even sum, moved one float64 step towards the
    exact value where it is inexact and even; the exact error from
    TwoSum), and rounding that to float32 gives the correctly rounded
    result (Boldo and Melquiond: 53 >= 24 + 2 bits)."""
    p = x.double() * a
    s = p + b
    bb = s - p
    err = (p - (s - bb)) + (b - bb)                  # p + b = s + err
    even = s.view(torch.int64).remainder(2).eq(0)
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where(err.ne(0) & even, torch.nextafter(s, toward), s)
    return s.float()


def fma_chain_plain(x: torch.Tensor, a: float, b: float,
                    depth: int) -> torch.Tensor:
    """The plain version of :func:`fma_chain`: ``depth`` links of
    fmaf(x, a, b) in float32, each rounded once (bit-equal to the
    kernel's chain)."""
    a, b = _f32(a), _f32(b)
    x = x.float()
    for _ in range(depth):
        x = _fmaf(x, a, b)
    return x


def _f32(v: float) -> float:
    """``v`` rounded to float32, as the kernel receives it."""
    return float(torch.tensor(v, dtype=torch.float32))


def fma_chain(x: torch.Tensor, a: float, b: float,
              depth: int) -> torch.Tensor:
    """``depth`` chained FMAs x <- x * a + b on every element of ``x``
    (2 depth flops an element), into a new tensor.  CUDA tensors must be
    contiguous float32 with a multiple of 4 elements, 16-byte aligned;
    ``depth`` one of ``DEPTHS``."""
    if depth not in DEPTHS:
        raise ValueError(f"depth must be one of {DEPTHS}, got {depth}")
    if x.device.type == "cpu":
        return fma_chain_plain(x, a, b, depth)
    if x.device.type != "cuda":
        raise ValueError(f"no FMA kernel for device {x.device}")
    if (x.dtype != torch.float32 or not x.is_contiguous()
            or x.numel() == 0 or x.numel() % 4 or x.data_ptr() % 16):
        raise ValueError("the FMA kernel takes a contiguous, 16-byte aligned "
                         "float32 tensor of a positive multiple of 4 "
                         f"elements; got {x.dtype} {tuple(x.shape)}")
    out = torch.empty_like(x)
    dev = x.device
    KERNEL(dev.index, x.data_ptr(), out.data_ptr(), a, b, x.numel(), depth,
           launch.stream(dev.index))
    return out
