"""Tracing and profiling utilities (port of
``spectrobot_tpu.utils.profiling``).

``trace()`` records everything inside the context with ``torch.profiler``
(host operations and, on a GPU, the device kernels, those the CUDA
kernels of ``csrc/`` launch through ctypes included) and writes a Chrome
trace; ``annotate`` names a physics stage in that trace and, on a GPU, as
an NVTX range; ``stopwatch`` times a block on the host clock after the
device has finished; ``kernel_roofline`` gives a kernel's rates from its
pair count and wall time.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from typing import Iterator, Optional

import torch


def _sync() -> None:
    """Wait for the device, if CUDA has been used in this process."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[object]:
    """Record the block with ``torch.profiler`` (CPU activities, and CUDA
    ones when a GPU is present) and write the Chrome trace
    ``<log_dir>/trace.json`` (default ``log_dir``: ``spectrobot_trace``
    under the temporary directory).  Yields the profiler, whose
    ``key_averages()`` and ``events()`` the caller may read after the
    block."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "spectrobot_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Name a physics stage: a ``torch.profiler.record_function`` range in
    a trace and, when CUDA is present, an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def stopwatch(label: str, sink=None) -> Iterator[None]:
    """Wall-clock a block, the device synchronized before each reading of
    the clock; report to ``sink`` (a ``utils.runlog.RunLogger``) or to
    stderr."""
    _sync()
    t0 = time.time()
    yield
    _sync()
    dt = time.time() - t0
    if sink is not None:
        sink.log({"stage": label, "wall_s": dt})
    else:
        print(f"[stopwatch] {label}: {dt:.3f}s", file=sys.stderr)


def kernel_roofline(n_pairs: float, wall_s: float,
                    flops_per_pair: float = 60.0,
                    bytes_per_pair: float = 0.08) -> dict:
    """Rates of an opacity kernel from its (point, line) pairs and wall
    time: pairs/s, and the flop and byte rates and arithmetic intensity at
    ``flops_per_pair`` and ``bytes_per_pair``.

    The defaults describe the reference's TPU Pallas kernel (about 60 flops
    a pair amortised over its region-dispatched Humlicek evaluation, about
    0.08 B a pair of HBM traffic over its tile reuse); they are not
    measured for the CUDA kernels or the H100.  Pass a kernel's own
    per-pair counts (``chip_smoke.py`` derives them per region) for a
    figure about the card."""
    return {
        "pairs_per_s": n_pairs / wall_s,
        "est_gflops": n_pairs * flops_per_pair / wall_s / 1e9,
        "est_gbytes": n_pairs * bytes_per_pair / wall_s / 1e9,
        "arithmetic_intensity_flops_per_byte":
            flops_per_pair / bytes_per_pair,
    }
