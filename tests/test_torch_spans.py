"""The port's spans and LM counters (spectrobot_tpu_torch/utils/profiling.py
``annotate``/``spans``, retrieval/oe.py ``COUNTS``), on the CPU:

- a tiny CLI retrieval under ``torch.profiler`` records every span the
  benchmark's readers read, nested as they assume (one set of forward
  phases a Jacobian, the Jacobian and the host algebra inside an LM
  iteration), each also a ``record_function`` range of the trace;
- with no profiler ``annotate`` is a ``nullcontext``, nothing is recorded
  and no CUDA event made, and the retrieval is bit-equal to the profiled
  one; with a profiler every span takes its two timing events where CUDA
  is in use;
- ``jacfwd`` (whole or chunked) through the spans gives the Jacobian it
  gives without them;
- the Jacobian that a planted rejected step repeats is counted;
- the bounded list drops its oldest record and counts the drop;
- the mesh's ranges keep their names (``halo_overlap`` reads them)."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spectrobot_tpu_torch import cli
from spectrobot_tpu_torch.parallel import graphed
from spectrobot_tpu_torch.parallel.collectives import (
    EXCHANGE_RANGE, OWN_SUM_RANGE)
from spectrobot_tpu_torch.retrieval import oe
from spectrobot_tpu_torch.retrieval.state import (
    jacobian_fwd, jacobian_fwd_chunked)
from spectrobot_tpu_torch.utils import profiling

import torch_mesh_cases as cases

torch.set_num_threads(1)

CPU = torch.device("cpu")
TINY_TOML = """\
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 256
[scene]
n_levels = 7
z_top_m = 60e3
[geometry]
tangent_heights_km = [8.0, 25.0]
n_sub = 2
[instrument]
enabled = true
fwhm_cm1 = 0.4
n_channels = 32
[compute]
chunk = 128
"""
PHASES = ("spectrobot.forward.path", "spectrobot.forward.prologue",
          "spectrobot.forward.line_sum", "spectrobot.forward.epilogue",
          "spectrobot.forward.ils")
ALGEBRA = ("spectrobot.lm.normal_equations", "spectrobot.lm.solve",
           "spectrobot.lm.cost")
NAMES = set(PHASES) | set(ALGEBRA) | {
    "spectrobot.jacobian", "spectrobot.lm.iteration",
    "spectrobot.lm.posterior"}


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """The CLI's retrieval problem of a tiny limb scene (7 levels, 2 rays,
    256 points, 32 channels; float32) and observations from a truth 3 K
    warmer below 30 km, with 1 % noise."""
    path = tmp_path_factory.mktemp("cfg") / "tiny.toml"
    path.write_text(TINY_TOML)
    cfg = cli.load_config(str(path))
    scene = cli.build_scene(cfg, CPU)
    prob = cli.retrieval_problem(cfg, scene, cli.select_engine(cfg, CPU))
    n_x = int(prob.x0.shape[0])
    jac = cli.make_jacobian(cfg, prob.fwd_flat, n_x, int(scene.nu.shape[0]),
                            CPU)
    warm = torch.where(prob.atm.z < 30e3, 3.0, 0.0).to(prob.x0.dtype)
    y = prob.fwd_flat(prob.x0 + warm).double().numpy()
    sigma = np.full_like(y, 0.01 * y.max())
    y = y + sigma * np.random.default_rng(5).standard_normal(y.shape)
    S_a = np.diag(np.full(n_x, cfg.retrieval.sigma_T ** 2))
    return prob, jac, y, sigma, S_a


def _retrieve(problem):
    prob, jac, y, sigma, S_a = problem
    return oe.retrieve(prob.fwd_flat, jac, y, prob.x0, prob.x0, S_a, sigma,
                       oe.OEConfig(max_iter=3))


@pytest.fixture(scope="module")
def profiled(problem):
    """One retrieval under the profiler: (result, span records, the
    profiler's event names)."""
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _retrieve(problem)
    recs = profiling.spans()
    profiling.reset_spans()
    return res, recs, {e.name for e in prof.events()}


def _ancestors(rec, by_id):
    out, p = [], rec["parent"]
    while p is not None and p in by_id:
        out.append(by_id[p]["name"])
        p = by_id[p]["parent"]
    return out


def test_retrieval_spans_nest_as_the_readers_assume(profiled):
    res, recs, events = profiled
    by_id = {r["id"]: r for r in recs}
    assert {r["name"] for r in recs} == NAMES
    assert NAMES <= events
    iters = [r for r in recs if r["name"] == "spectrobot.lm.iteration"]
    jacs = [r for r in recs if r["name"] == "spectrobot.jacobian"]
    assert len(iters) == res.n_iter and len(jacs) == res.n_iter + 1
    # One Jacobian an iteration, the posterior's outside the loop.
    assert [_ancestors(j, by_id) for j in jacs] == (
        [["spectrobot.lm.iteration"]] * res.n_iter + [[]])
    for j in jacs:
        under = [r["name"] for r in recs
                 if j["id"] in _reach(r, by_id)]
        assert sorted(under) == sorted(PHASES)
    for r in recs:
        if r["name"] in ALGEBRA:
            assert by_id[r["parent"]]["name"] == "spectrobot.lm.iteration"
        if r["name"] in PHASES:
            # A Jacobian's forward, an iteration's trial forward, or the
            # first forward before the loop.
            assert _ancestors(r, by_id)[:1] in (
                ["spectrobot.jacobian"], ["spectrobot.lm.iteration"], [])
        assert r["host_ms"] >= 0.0 and r["device_ms"] is None
    names = [r["name"] for r in recs]
    # The first forward, one Jacobian and one trial an iteration, the
    # posterior's Jacobian.
    assert all(names.count(p) == 2 * res.n_iter + 2 for p in PHASES)
    (post,) = [r for r in recs if r["name"] == "spectrobot.lm.posterior"]
    assert post["parent"] is None


def _reach(rec, by_id):
    """The ids of the records that hold ``rec``."""
    out, p = set(), rec["parent"]
    while p is not None and p in by_id:
        out.add(p)
        p = by_id[p]["parent"]
    return out


class _Event:
    """A stand-in for ``torch.cuda.Event`` that counts what is made and
    reads the order of its records as its time."""
    made = recorded = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1
        self.t = None

    def record(self, stream=None):
        _Event.recorded += 1
        self.t = _Event.recorded

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_no_profiler_records_nothing_and_changes_nothing(problem, profiled,
                                                         monkeypatch):
    """Where CUDA is in use (faked), a run without a profiler makes no
    event and keeps no record, with results bit-equal to the profiled
    run's; under a profiler every span takes its two events."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    _Event.made = 0
    profiling.reset_spans()
    assert isinstance(profiling.annotate("x"), contextlib.nullcontext)
    res = _retrieve(problem)
    assert _Event.made == 0 and profiling.spans() == []
    ref = profiled[0]
    assert res.n_iter == ref.n_iter and res.chi2 == ref.chi2
    np.testing.assert_array_equal(res.x, ref.x)
    np.testing.assert_array_equal(res.K, ref.K)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                pass
    recs = profiling.spans()
    profiling.reset_spans()
    assert _Event.made == 4 and [r["name"] for r in recs] == ["outer",
                                                               "inner"]
    assert recs[1]["parent"] == recs[0]["id"]
    assert all(r["device_ms"] is not None and r["device_ms"] > 0
               for r in recs)


@pytest.mark.parametrize("chunk", [None, 3])
def test_jacfwd_through_the_spans_is_unchanged(problem, chunk):
    prob = problem[0]
    x = prob.x0 + 1.0
    plain = torch.func.jacfwd(prob.fwd_flat)(x)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        got = (jacobian_fwd(prob.fwd_flat, x) if chunk is None
               else jacobian_fwd_chunked(prob.fwd_flat, x, chunk=chunk))
    names = [r["name"] for r in profiling.spans()]
    profiling.reset_spans()
    if chunk is None:
        torch.testing.assert_close(got, plain, rtol=0.0, atol=0.0)
    else:
        torch.testing.assert_close(got, plain)
    n_sets = 1 if chunk is None else -(-int(x.shape[0]) // chunk)
    assert names.count("spectrobot.jacobian") == 1
    assert all(names.count(p) == n_sets for p in PHASES)


@pytest.mark.parametrize("max_iter,want", [
    (2, {"jacobians": 3, "jacobians_repeated": 1}),
    (1, {"jacobians": 2, "jacobians_repeated": 1}),
])
def test_rejected_step_is_counted(max_iter, want):
    """A linear problem whose first trial forward is planted far off: the
    step is rejected, so the next Jacobian (an iteration's, or the
    posterior's) is at the same state."""
    rng = np.random.default_rng(3)
    A = torch.as_tensor(rng.standard_normal((12, 4)))
    x_true = torch.as_tensor(rng.standard_normal(4))
    y = (A @ x_true).numpy()
    calls = []

    def forward(x):
        calls.append(1)
        return A @ x + (1e3 if len(calls) == 2 else 0.0)

    before = dict(oe.COUNTS)
    x0 = torch.zeros(4, dtype=torch.float64)
    res = oe.retrieve(forward, lambda x: A, y, x0, x0, np.eye(4),
                      np.full(12, 0.1),
                      oe.OEConfig(max_iter=max_iter, dx2_tol=0.0,
                                  chi2_rel_tol=0.0))
    got = {k: oe.COUNTS[k] - before[k] for k in oe.COUNTS}
    assert got == want
    assert [h["accepted"] for h in res.history] == [False, True][:max_iter]


def test_bounded_list_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with profiling.annotate(f"s{i}"):
                pass
    assert [r["name"] for r in profiling.spans()] == ["s2", "s3", "s4"]
    assert profiling.dropped_spans() == 2
    profiling.reset_spans()
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


class _Replayed:
    def replay(self):
        pass


def test_mesh_ranges_keep_their_names(tmp_path):
    """The nu-halo forward on two gloo ranks opens the exchange's and the
    own sum's ranges, and a graph's replay its own (halo_overlap's host
    marks read these names)."""
    assert (EXCHANGE_RANGE, OWN_SUM_RANGE, graphed.REPLAY_RANGE) == (
        "ring_exchange_issue", "halo_own_line_sum", "mesh_graph_replay")
    for events, spans in cases.run(tmp_path, 2, cases.mesh_ranges_case,
                                   256, 40, 2):
        assert {EXCHANGE_RANGE, OWN_SUM_RANGE} <= events
        assert {EXCHANGE_RANGE, OWN_SUM_RANGE} <= set(spans)
    g = graphed._Graph.__new__(graphed._Graph)
    g.inputs, g.graph, g.launches = [torch.zeros(2)], _Replayed(), {}
    g.spans = ()
    g.out = torch.ones(2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        g.replay([torch.ones(2)])
    assert graphed.REPLAY_RANGE in {e.name for e in prof.events()}
    profiling.reset_spans()
