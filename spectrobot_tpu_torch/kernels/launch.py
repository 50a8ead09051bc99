"""Launch the package's CUDA kernels: the one list of them, and how each
launch is bound, made, counted and checked.

Each kernel source ``csrc/<name>.cu`` has a plain C interface:
``<name>_launch`` returns a CUDA error code (0: launched) and
``<name>_error_string`` names a code.  A wrapper declares its library once,

    KERNEL = launch.Kernel("opacity_batch", argtypes, geometry)

which builds and binds nothing at import.  The first launch builds the
library (``build.load``), binds both functions and checks the geometry the
wrapper assumes against the library's own.  Calling the :class:`Kernel`
launches, adds one to ``LAUNCHES`` and raises on a non-zero code.

``LAUNCHES`` counts by the ``__global__`` name a profiler trace shows
(``KERNELS``), so :func:`kernel_launches` reads the same counts from a
trace's device events.  A CUDA graph's capture (``parallel.graphed``)
takes back the increments it made and adds them again at every replay: a
count says how many launches the device ran.

The per-stream scratch of a launch (:func:`arrival_counters`,
:func:`scratch`) is cached by its owner, card and stream, and a capture
takes its streams' scratch out of the cache (:func:`take`): a recycled
stream handle never shares a graph's.

This module imports only ``ctypes``, ``torch`` and ``build``: nothing
above the kernels.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict, Optional, Sequence

import torch

from spectrobot_tpu_torch.kernels import build

# Every kernel library (csrc/<name>.cu) and the __global__ whose launches
# it counts: a trace's kernels are named so.
KERNELS = {"opacity_batch": "opacity_batch_kernel",
           "basis_batch": "basis_batch_kernel",
           "basis_transpose": "basis_transpose_kernel",
           "opacity_single": "opacity_single_kernel",
           "basis_single": "basis_single_kernel",
           "fma_peak": "fma_chain_kernel",
           "dma_ring": "dma_ring_kernel",
           "dma_halo": "dma_halo_kernel",
           "rt_epilogue": "rt_epilogue_kernel"}

# Kernel launches made in this process, by __global__ name.
LAUNCHES: Counter = Counter()

# The launches' per-stream scratch, {(owner, kind, device, raw stream
# handle): tensor}.
_PER_STREAM: dict = {}


class Kernel:
    """The library of ``csrc/<name>.cu``, bound at its first launch.
    ``argtypes``: those of ``<name>_launch``; ``geometry``: {function of
    the library taking no argument: the value the wrapper assumes};
    ``functions``: {other function: (argtypes, restype)} to bind.
    ``bound``: the library launches go to (None until the first)."""

    def __init__(self, name: str, argtypes: Sequence,
                 geometry: Optional[Dict[str, int]] = None,
                 functions: Optional[Dict[str, tuple]] = None):
        self.name = name
        self.kernel = KERNELS[name]
        self.argtypes = list(argtypes)
        self.geometry = dict(geometry or {})
        self.functions = dict(functions or {})
        self.bound: Optional[ctypes.CDLL] = None

    def bind(self, path: Optional[str] = None) -> ctypes.CDLL:
        """The library built from ``csrc/<name>.cu`` (or the one at
        ``path``, a build of the same interface), its functions bound and
        its geometry checked against the wrapper's."""
        lib = build.load(self.name) if path is None else ctypes.CDLL(path)
        fn = getattr(lib, f"{self.name}_launch")
        fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        err = getattr(lib, f"{self.name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        for name, (argtypes, restype) in self.functions.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        got = tuple(getattr(lib, f)() for f in self.geometry)
        if got != tuple(self.geometry.values()):
            raise RuntimeError(f"{self.name} kernel geometry {got} != "
                               f"wrapper {tuple(self.geometry.values())}")
        return lib

    def library(self) -> ctypes.CDLL:
        """The bound library, bound on first use."""
        if self.bound is None:
            self.bound = self.bind()
        return self.bound

    def check(self, rc: int, what: str) -> None:
        """Raise a RuntimeError if the CUDA error code ``rc`` that ``what``
        returned is not 0."""
        if rc != 0:
            msg = getattr(self.library(),
                          f"{self.name}_error_string")(rc).decode()
            raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")

    def __call__(self, *args) -> None:
        """One launch: ``<name>_launch(*args)``, counted, its code
        checked."""
        rc = getattr(self.library(), f"{self.name}_launch")(*args)
        LAUNCHES[self.kernel] += 1
        self.check(rc, f"{self.name} kernel launch")


def stream(index: int) -> int:
    """The raw handle of PyTorch's current stream on card ``index`` (what
    ``torch.cuda.current_stream(index).cuda_stream`` gives, without
    building a Stream object: a wrapper's host time is part of its
    call's)."""
    return torch._C._cuda_getCurrentRawStream(index)


def kernel_launches(names: Sequence[str]) -> Counter:
    """The launches of every kernel among the device events named
    ``names`` (a profiler trace), by ``KERNELS``' names."""
    return Counter({k: sum(k in n for n in names)
                    for k in KERNELS.values()})


def _cached(key: tuple, n: int, make, dtype: torch.dtype,
            least: int) -> torch.Tensor:
    have = _PER_STREAM.get(key)
    if have is None or have.numel() < n:
        have = _PER_STREAM[key] = make(max(n, least), dtype=dtype,
                                       device=key[2])
    return have


def arrival_counters(owner: str, dev: torch.device, stream: int,
                     n: int) -> torch.Tensor:
    """At least ``n`` zero int32 arrival counters for ``owner``'s launches
    on ``stream`` (each launch leaves them zero, so no call runs a fill
    kernel)."""
    return _cached((owner, "counters", dev, stream), n, torch.zeros,
                   torch.int32, 1024)


def scratch(owner: str, dev: torch.device, stream: int,
            n: int) -> torch.Tensor:
    """At least ``n`` float32 of scratch for ``owner``'s launches on
    ``stream``, which only a launch reads and writes (grown on demand)."""
    return _cached((owner, "scratch", dev, stream), n, torch.empty,
                   torch.float32, 1 << 16)


def take(streams: Sequence[torch.cuda.Stream]) -> list:
    """Take the scratch cached for ``streams`` out of the cache and return
    it."""
    handles = {s.cuda_stream for s in streams}
    return [_PER_STREAM.pop(k) for k in list(_PER_STREAM)
            if k[-1] in handles]
