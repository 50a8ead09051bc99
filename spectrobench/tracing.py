"""The traced segment of a ``--trace 1`` run: a few units of the cell's
traffic under ``torch.profiler`` after the measured window, each unit in a
range of its own, and what the metric readers and the breakdown take from
it: the device's intervals by kernel name and stream, the units' ranges,
the window's length, and the work the line sums of the segment required
(counted by the yardstick from the states the driver recorded)."""

from __future__ import annotations

import time

import torch

from spectrobench.drivers import SPAN
from spectrobench.yardstick import roofline
from spectrobench.yardstick.trace import busy_us, family, idle_gaps

WINDOW = "spectrobench_traced_window"
UNIT = "spectrobench_unit_"
# Host seconds the profiler runs before the first unit (the port's
# chip_smoke found that ranges begun at once could miss a ctypes launch).
SETTLE_S = 0.05
# Entries of each list of the breakdown.
TOP = 10


def trace_units(driver, indices, device: torch.device,
                barrier=None) -> dict:
    """Run ``driver.unit(i)`` for ``indices`` in a window under the
    profiler, after one unit outside it (on a mesh every rank's profiler
    runs before ``barrier()`` lets the window start).  Returns
    {"window_us", "events": [(name, start_us, end_us, stream)], "units":
    [(start_us, end_us)], "host": [(name, start_us, end_us)], "calls"}, times
    from the window's start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        # One unit before the window: the profiler's own start-up (its
        # buffer requests) stays out of it.
        driver.unit(indices[0])
        time.sleep(SETTLE_S)
        if barrier is not None:
            barrier()
        driver.calls = []
        with record_function(WINDOW):
            for j, i in enumerate(indices):
                with record_function(f"{UNIT}{j}"):
                    driver.unit(i)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    calls, driver.calls = driver.calls, None
    events = prof.events()
    (win,) = [e for e in events if e.name == WINDOW
              and e.device_type == DeviceType.CPU]
    w0, w1 = win.time_range.start, win.time_range.end
    dev, host, units = [], [], {}
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if (e.name == WINDOW or e.name.startswith(UNIT)
                    or getattr(e, "is_user_annotation", False)):
                continue
            s, t = max(s, w0), min(t, w1)
            if s < t:
                dev.append((e.name, s - w0, t - w0, e.device_resource_id))
        elif w0 <= s <= w1:
            if e.name.startswith(UNIT):
                units[int(e.name[len(UNIT):])] = (s - w0, t - w0)
            elif e.name != WINDOW:
                host.append((e.name, s - w0, t - w0))
    return {"window_us": w1 - w0, "events": dev,
            "units": [units[j] for j in sorted(units)], "host": host,
            "calls": calls}


def count_work(inputs, calls, device) -> dict:
    """The bounds [ms] of the line sums the recorded calls required: K1's
    at every forward and Jacobian, K2's at every Jacobian (2 n_x rows),
    each from the yardstick's region counts of the call's state over the
    scene's whole grid (each distinct state counted once)."""
    scene, seen, k1, k2 = inputs.scene, {}, [], []
    P = scene.nu.shape[0]
    for kind, T, vmr in calls:
        key = (T.tobytes(), vmr.tobytes())
        if key not in seen:
            nu, nu_c, sx, y, live = inputs.ref.required_work(scene, T, vmr,
                                                             device)
            pairs = roofline.region_counts(nu, nu_c, sx, y, live,
                                           scene.cutoff)
            seen[key] = (pairs, nu_c.shape[0], nu_c.shape[1])
        pairs, B, L = seen[key]
        k1.append(roofline.k1_bound_ms(pairs, B, L, P))
        if kind == "jacobian":
            k2.append(roofline.k2_bound_ms(pairs, B, L, P, 2 * T.shape[0]))
    return {"k1_ms": k1, "k2_ms": k2}


def gap_label(host, t: float) -> str:
    """What the host was doing at ``t``: the innermost of the drivers'
    ranges open then, and the innermost other event (an operator or a
    runtime call) inside it, or "python" where none is open."""
    def inner(events):
        found = [(t1 - t0, n) for n, t0, t1 in events if t0 <= t <= t1]
        return min(found)[1] if found else None
    phase = inner(e for e in host if e[0].startswith(SPAN))
    op = inner(e for e in host if not e[0].startswith(SPAN))
    return (f"{phase[len(SPAN):] if phase else 'harness'}: "
            f"{op if op else 'python'}")


def breakdown(tr: dict) -> dict:
    """The device's largest operations by family and the longest idle gaps,
    each labelled with what the host was doing at its middle
    (:func:`gap_label`): at most ``TOP`` entries each, [name, seconds]."""
    by = {}
    for name, s, e, _ in tr["events"]:
        f = family(name)
        by[f] = by.get(f, 0.0) + (e - s) / 1e6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle_gaps([(s, e) for _, s, e, _ in tr["events"]], 0.0,
                            tr["window_us"]), key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:TOP]:
        out.append([gap_label(tr["host"], 0.5 * (s + e)), (e - s) / 1e6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": out}


def busy_s(tr: dict) -> float:
    return busy_us([(s, e) for _, s, e, _ in tr["events"]]) / 1e6


def summary(tr: dict) -> dict:
    """What a rank sends rank 0: its events, units and window (the host
    ranges stay on the rank)."""
    return {k: tr[k] for k in ("window_us", "events", "units")}
