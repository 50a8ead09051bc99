"""What the drivers of every kind of traffic share.  A kind of traffic
lives in ``kinds/<kind>.py`` (found by name, :func:`spectrobench.manifest.
driver`): a class ``Driver`` built on :class:`Driver` below, which loops
over the program and compares what it produced with the plain reference
(``inputs.ref``).

A driver is built on a run's inputs (:mod:`spectrobench.inputs`), a
device and a mesh (None on one card), and offers:

- ``setup()``: the program's scene, its callables and what the traffic
  needs (the retrieval's observations), then one warm unit of every shape;
- ``unit(i)``: the i-th unit of work of the window (one retrieval, one
  spectrum), timed on the host, its outputs kept for the check;
- ``calls``: while not None, the states of the line-sum calls made (the
  traced segment's work is counted from them);
- ``release()``: drops the program's state before the reference runs;
- ``check(control)``: ``{"program": {number: reading}, "control":
  {number: reading} or None, "checked": units compared}``, the control's
  readings (``control``) taken at the same inputs and states;
- ``reference_s``: the seconds ``setup()`` spent on the reference's own
  work (observations it makes for the traffic), which the set-up time
  leaves out.

Every time is from ``time.perf_counter``; a unit ends when its results
are on the host.  The phases of a unit run in profiler ranges named
``SPAN`` + phase, which label a traced run's idle gaps.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch


# The prefix of the drivers' profiler ranges.
SPAN = "spectrobench."


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def worst(a: float, b: float) -> float:
    """The larger of two readings; a reading that is not a finite number
    is the worst of all."""
    a, b = float(a), float(b)
    if not (np.isfinite(a) and np.isfinite(b)):
        return float("inf")
    return max(a, b)


now = time.perf_counter


def cache_dir() -> Path:
    """The benchmark's own cache: ``spectrobench`` under
    ``XDG_CACHE_HOME`` (else ``~/.cache``)."""
    root = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(root) / "spectrobench"


class Driver:
    """What every kind shares: the program's scene and engine."""

    reference_s = 0.0

    def __init__(self, inputs, device: torch.device, mesh=None):
        self.inputs, self.device, self.mesh = inputs, device, mesh
        self.cfg = inputs.cfg
        self.calls = None
        self.kept = {}

    def _build(self):
        from spectrobot_tpu_torch import cli
        self.cli = cli
        self.engine = cli.select_engine(self.cfg, self.device)
        self.scene = cli.build_scene(self.cfg, self.device)

    def _record(self, kind: str, T, vmr) -> None:
        """Note a line-sum call at temperature ``T`` and CO2 VMR ``vmr``
        [n_lev] while ``calls`` collects them."""
        if self.calls is not None:
            host = lambda v: (v.detach().double().cpu().numpy()
                              if isinstance(v, torch.Tensor)
                              else np.asarray(v, np.float64))
            self.calls.append((kind, host(T), host(vmr)))

    def release(self) -> None:
        for name in ("scene", "fwd", "oe"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
