"""Tracing and profiling utilities (port of
``spectrobot_tpu.utils.profiling``).

``trace()`` records everything inside the context with ``torch.profiler``
(host operations and, on a GPU, the device kernels, those the CUDA
kernels of ``csrc/`` launch through ctypes included) and writes a Chrome
trace; ``annotate`` is the port's one span helper: while a profiler runs it
names a stage in that trace and keeps a record of it (host and device
time, the span that holds it), which ``spans()`` returns, and otherwise
costs a check of the profiler's state.  Inside a CUDA graph's capture
(``capturing_spans``) a span records its boundaries as timing events in
the graph, and each replay made while a profiler runs adds a record of it
(``replayed_spans``).  For NVTX ranges, run under
``torch.autograd.profiler.emit_nvtx()``: it turns the same ranges into
NVTX ranges.  ``stopwatch`` times a block on the host clock after the
device has finished; ``kernel_roofline`` gives a kernel's rates from its
pair count and wall time.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import tempfile
import time
from typing import Iterator, List, Optional

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


# The span records kept at most; past this the oldest go (and are counted).
MAX_SPANS = 65536
_records: collections.deque = collections.deque()
_open: List[dict] = []
_ids = itertools.count()
_dropped = 0


class _Span:
    """One span of :func:`annotate` while a profiler runs."""

    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        rec = {"id": next(_ids), "name": self.name,
               "parent": _open[-1]["id"] if _open else None,
               "events": None}
        if (torch.cuda.is_available() and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            rec["events"] = (torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True))
            rec["events"][0].record()
        _keep(rec)
        _open.append(rec)
        self.rec = rec
        rec["t0_ns"] = time.perf_counter_ns()

    def __exit__(self, *exc):
        rec = self.rec
        rec["t1_ns"] = time.perf_counter_ns()
        if rec["events"] is not None:
            rec["events"][1].record()
        _open.pop()
        return self.rf.__exit__(*exc)


class _CapturedSpan:
    """One span of :func:`annotate` inside :func:`capturing_spans`: two
    timing events recorded in the graph under capture, kept in the
    capture's list with the index of the captured span that holds it."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = {"name": self.name,
               "parent": _captured_open[-1] if _captured_open else None,
               "events": (torch.cuda.Event(enable_timing=True, external=True),
                          torch.cuda.Event(enable_timing=True, external=True))}
        rec["events"][0].record()
        _captured_open.append(len(_captured))
        _captured.append(rec)

    def __exit__(self, *exc):
        _captured[_captured_open.pop()]["events"][1].record()
        return False


# The spans met in the CUDA graph capture under way (capturing_spans), and
# the indices of those open; None outside a capture.
_captured: Optional[List[dict]] = None
_captured_open: List[int] = []


@contextlib.contextmanager
def capturing_spans() -> Iterator[List[dict]]:
    """Around a CUDA graph's capture: every :func:`annotate` span met
    inside records its entry and exit as timing events in the graph
    (``external``: each replay records them again), profiler or not.
    Yields the list of the captured spans ({"name", "parent": the index of
    the captured span that holds it, or None, "events"}), outermost first,
    for :func:`replayed_spans`."""
    global _captured, _captured_open
    outer = _captured, _captured_open
    _captured, _captured_open = [], []
    try:
        yield _captured
    finally:
        _captured, _captured_open = outer


def replayed_spans(captured: List[dict]) -> None:
    """After a replay of a graph whose capture met the spans ``captured``
    (:func:`capturing_spans`), while a profiler runs: one record for
    :func:`spans` of each, under the span open now, with the device time
    between the events the replay recorded.  It waits for the replay to
    record them (the next replay records them again); host time it has
    none.  Without a profiler, or with nothing captured, it does
    nothing."""
    if not captured or not torch._C._autograd._profiler_enabled():
        return
    for c in captured:
        c["events"][1].synchronize()
    outer = _open[-1]["id"] if _open else None
    ids: List[int] = []
    for c in captured:
        ids.append(next(_ids))
        start, end = c["events"]
        _keep({"id": ids[-1], "name": c["name"],
               "parent": outer if c["parent"] is None else ids[c["parent"]],
               "events": None, "device_ms": start.elapsed_time(end)})


def _keep(rec: dict) -> None:
    """Append a record, letting the oldest go past :data:`MAX_SPANS`."""
    global _dropped
    if len(_records) >= MAX_SPANS:
        _records.popleft()
        _dropped += 1
    _records.append(rec)


def annotate(name: str):
    """The port's span: inside :func:`capturing_spans`, two timing events
    in the graph under capture.  Otherwise, while a profiler runs
    (``torch.autograd.profiler`` or ``torch.profiler``, ``emit_nvtx``
    included), a ``torch.profiler.record_function`` range named ``name``,
    which lies on the profiler's clock beside the device's kernels, and a
    record for :func:`spans` (the enclosing span, host start and end, and
    on CUDA outside stream capture a pair of timing events on the current
    stream).  Otherwise ``contextlib.nullcontext()``: no range, no record,
    no event."""
    if _captured is not None:
        return _CapturedSpan(name)
    if torch._C._autograd._profiler_enabled():
        return _Span(name)
    return contextlib.nullcontext()


def spans() -> List[dict]:
    """The records of the spans closed so far, oldest first (at most
    :data:`MAX_SPANS`; :func:`dropped_spans` counts the older ones let go),
    after one synchronisation: each {"id", "name", "parent" (the id of the
    span that held it, or None), "host_ms", "device_ms"}.

    ``device_ms`` is the current stream's time from the span's entry to its
    exit (None on the CPU or under stream capture): from the phase's first
    launch to its last where the device keeps up, but where the host
    issues the phase more slowly than the device runs it, it includes the
    idle while the device waited for the host.  A span replayed from a
    CUDA graph (:func:`replayed_spans`) has the device time of its replay,
    which no host issue stretches, and ``host_ms`` None."""
    done = [r for r in _records if "t1_ns" in r or "device_ms" in r]
    if any(r["events"] is not None for r in done):
        torch.cuda.synchronize()
    out = []
    for r in done:
        ev = r["events"]
        out.append({"id": r["id"], "name": r["name"], "parent": r["parent"],
                    "host_ms": ((r["t1_ns"] - r["t0_ns"]) / 1e6
                                if "t1_ns" in r else None),
                    "device_ms": (r.get("device_ms") if ev is None
                                  else ev[0].elapsed_time(ev[1]))})
    return out


def dropped_spans() -> int:
    """The span records let go since the last :func:`reset_spans`, the
    oldest first, once :data:`MAX_SPANS` were kept.  A mean over
    :func:`spans` is taken only where this is 0 (the benchmark's span
    readers give none otherwise)."""
    return _dropped


def reset_spans() -> None:
    """Forget every span record and the count of those let go."""
    global _dropped
    _records.clear()
    _dropped = 0


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
