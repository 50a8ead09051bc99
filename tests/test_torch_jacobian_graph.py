"""The single-card Jacobian's CUDA-graph route (retrieval/state.py
``jacobian_graphed``, through cli.py ``make_jacobian`` and
``retrieval_problem``) on the CPU, where no graph is made:

- the CPU Jacobian stays eager, bit-equal to ``torch.func.jacfwd``, and
  counts neither a capture nor a replay;
- with the route forced as on the card and a stand-in for the capture
  (``torch_mesh_cases.EagerCapture``): two rebuilds of the problem of one
  scene and configuration share one capture, and every later call
  replays; a changed scene, retrieval setting, engine or dtype captures
  anew; forwards keep their graphs side by side while their pools and the
  next Jacobian fit the guard's limit, the least recently called released
  first past it; the counters count each;
- the mesh (the CLI's retrieve on 2 gloo ranks), the chunked Jacobian and
  the reverse gradient (``analytic_jvp='rev'``) never take the route, and
  the chunked and the mesh Jacobians release the graphs held beside them;
- the CLI's one-shot retrieve runs its Jacobians eagerly;
- the Jacobian of each configuration the card replays (a limb slice, config
  3, the composed scene, float64, a node grid, the table, nadir) reads no
  tensor value on the host and makes no tensor from host data (on the card
  either would stop the capture);
- ``limb_path_cg`` and ``nadir_path_cg`` give the segment order the host
  built before, bit for bit;
- a scene that goes takes its problems and their graphs with it.

The graphs themselves run on the card
(tests/test_torch_jacobian_graph_cuda.py)."""

import gc
import weakref

import numpy as np
import pytest
import torch

from spectrobot_tpu_torch import cli
from spectrobot_tpu_torch.forward.geometry import limb_path_cg, nadir_path_cg
from spectrobot_tpu_torch.ops.cuda_basis import PLAIN
from spectrobot_tpu_torch.parallel import graphed
from spectrobot_tpu_torch.parallel.mesh import _free_port
from spectrobot_tpu_torch.retrieval import state
from spectrobot_tpu_torch.retrieval.state import GRAPH_COUNTS

import torch_mesh_cases as cases

torch.set_num_threads(1)

CPU = torch.device("cpu")
SLICE = {"grid.nu_min": "660.0", "grid.nu_max": "674.0",
         "grid.n_points": "256", "scene.n_levels": "7",
         "scene.z_top_m": "60e3", "geometry.tangent_heights_km": "8.0,25.0",
         "geometry.n_sub": "2", "instrument.enabled": "true",
         "instrument.fwhm_cm1": "0.4", "instrument.n_channels": "16"}
CONFIG3 = {**SLICE, "grid.nu_min": "2280.0", "grid.nu_max": "2400.0",
           "lines.source": "synthetic:co2_43um", "nlte.enabled": "true",
           "nlte.t_vib": "demo:co2_pump"}
CASES = {"slice": SLICE, "config3": CONFIG3,
         "composed": {**CONFIG3, "cia.enabled": "true",
                      "instrument.fov_fwhm_km": "3.0",
                      "instrument.fov_n_fine": "4"},
         "float64": {**SLICE, "compute.dtype": "float64"},
         "nodes": {**SLICE, "retrieval.n_nodes": "4"},
         "table": {**SLICE, "compute.use_lut": "true",
                   "compute.lut_n_T": "5", "compute.lut_n_p": "5"},
         "nadir": {**SLICE, "geometry.mode": "nadir",
                   "geometry.sec_theta": "1.0,1.5"}}
# A tensor made from host data: on the card, a copy to the device.
HOST_DATA = ("aten::lift_fresh",)


def _build(overrides, scene=None, engine=None):
    """(cfg, scene, problem, Jacobian callable) of the overrides on the
    CPU, on ``scene`` when given."""
    cfg = cli.load_config(None, overrides)
    scene = cli.build_scene(cfg, CPU) if scene is None else scene
    engine = cli.select_engine(cfg, CPU) if engine is None else engine
    prob = cli.retrieval_problem(cfg, scene, engine)
    jac = cli.make_jacobian(cfg, prob.fwd_flat, int(prob.x0.shape[0]),
                            int(scene.nu.shape[0]), CPU)
    return cfg, scene, prob, jac


def _counts(before):
    return {k: GRAPH_COUNTS[k] - before[k] for k in GRAPH_COUNTS}


@pytest.fixture
def forced(monkeypatch):
    """The route as on the card (constants take it), the capture a
    stand-in that runs the body."""
    monkeypatch.setattr(graphed, "graph_route", graphed.constant_call)
    monkeypatch.setattr(graphed, "_Graph", cases.EagerCapture)
    cases.EagerCapture.made = []
    return cases.EagerCapture


@pytest.fixture
def slice_scene():
    """A scene of its own for each test: its graphs are the test's."""
    cfg = cli.load_config(None, SLICE)
    return cli.build_scene(cfg, CPU)


def test_cpu_jacobian_stays_eager_and_equals_jacfwd(slice_scene):
    _, _, prob, jac = _build(SLICE, slice_scene)
    before = dict(GRAPH_COUNTS)
    x = prob.x0 + 1.0
    K = [jac(x) for _ in range(2)]
    want = torch.func.jacfwd(prob.fwd_flat)(x)
    assert all(torch.equal(k, want) for k in K)
    assert _counts(before) == dict.fromkeys(GRAPH_COUNTS, 0)
    assert len(state._GRAPHED[prob.fwd_flat].graphs) == 0


def test_rebuilds_of_one_problem_share_one_capture(forced, slice_scene):
    """As the benchmark rebuilds the problem for every scan: one capture at
    the first Jacobian, replays after, each equal to jacfwd."""
    before = dict(GRAPH_COUNTS)
    got, fwds = [], set()
    for scan in range(2):
        _, _, prob, jac = _build(SLICE, slice_scene)
        fwds.add(prob.fwd_flat)
        for step in range(3):
            x = prob.x0 + 0.5 * step
            K = jac(x)
            got.append(torch.equal(K, torch.func.jacfwd(prob.fwd_flat)(x)))
    assert len(fwds) == 1 and all(got)
    assert len(forced.made) == 1
    assert _counts(before) == {"jacobian_graph_captures": 1,
                               "jacobian_graph_replays": 5}


@pytest.mark.parametrize("change", ["scene", "retrieval", "engine", "dtype"])
def test_a_changed_problem_captures_anew(forced, slice_scene, change):
    """A second scene of the same configuration, a retrieval on a node grid,
    the plain engine, or the float64 pipeline: a forward of its own, and a
    capture of its own."""
    before = dict(GRAPH_COUNTS)
    _, _, prob, jac = _build(SLICE, slice_scene)
    jac(prob.x0)
    other = {"scene": lambda: _build(SLICE),
             "retrieval": lambda: _build({**SLICE, "retrieval.n_nodes": "4"},
                                         slice_scene),
             "engine": lambda: _build(SLICE, slice_scene, PLAIN),
             "dtype": lambda: _build({**SLICE, "compute.dtype": "float64"})}
    _, _, prob2, jac2 = other[change]()
    assert prob2.fwd_flat is not prob.fwd_flat
    K = jac2(prob2.x0)
    assert torch.equal(K, torch.func.jacfwd(prob2.fwd_flat)(prob2.x0))
    assert _counts(before) == {"jacobian_graph_captures": 2,
                               "jacobian_graph_replays": 0}
    # x in another dtype, through the same forward: another key.
    jac(prob.x0.double())
    assert len(forced.made) == 3


@pytest.mark.parametrize("fits, want", [
    (10.0, ([[1, 0], [1, 1], [1, 1], [1, 1]], 2, 2)),
    (1.5, ([[1, 0], [0, 1], [1, 0], [0, 1]], 4, 0))])
def test_forwards_keep_their_graphs_within_the_limit(
        forced, slice_scene, monkeypatch, fits, want):
    """Two forwards' Jacobians in turns, each capture's pool as large as a
    Jacobian's counted bytes: under a limit of ten such, both keep their
    graphs and replay; under one and a half, a call releases the other's
    first, which captures again at its next call; equal to jacfwd."""
    cfg, _, prob, _ = _build(SLICE, slice_scene)
    n_x, n_fine = int(prob.x0.shape[0]), int(slice_scene.nu.shape[0])
    nbytes = cli.jacobian_bytes(cfg, n_x, n_fine)

    class Pooled(cases.EagerCapture):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.pool_bytes = nbytes

    monkeypatch.setattr(graphed, "_Graph", Pooled)
    monkeypatch.setattr(cli, "jacobian_limit", lambda device: fits * nbytes)
    before = dict(GRAPH_COUNTS)
    _, _, prob, jac = _build(SLICE, slice_scene)
    _, _, prob2, jac2 = _build(SLICE, slice_scene, PLAIN)
    fwds = (prob.fwd_flat, prob2.fwd_flat)
    held, equal = [], []
    for f, j in [(prob.fwd_flat, jac), (prob2.fwd_flat, jac2)] * 2:
        x = prob.x0 + len(held)
        equal.append(torch.equal(j(x), torch.func.jacfwd(f)(x)))
        held.append([len(state._GRAPHED[g].graphs) if g in state._GRAPHED
                     else 0 for g in fwds])
    assert all(equal)
    assert (held, *_counts(before).values()) == want


def test_chunked_and_mesh_jacobians_release_the_graphs(forced, slice_scene):
    """A graph held by one forward's Jacobian goes before a chunked
    Jacobian, and before a mesh rank's (``parallel.oe.ShardedOE``'s
    local Jacobian), each of which runs eagerly."""
    from types import SimpleNamespace

    from spectrobot_tpu_torch.parallel.oe import ShardedOE
    cfg, _, prob, jac = _build(SLICE, slice_scene)
    jac(prob.x0)
    body = state._GRAPHED[prob.fwd_flat]
    chunked = cli.make_jacobian(
        cli.load_config(None, {**SLICE, "retrieval.jac_chunk": "3"}),
        prob.fwd_flat, int(prob.x0.shape[0]), int(slice_scene.nu.shape[0]),
        CPU)
    rank = SimpleNamespace(_model=prob.fwd_flat)
    want = torch.func.jacfwd(prob.fwd_flat)(prob.x0)
    for other in (chunked, lambda x: ShardedOE._jac_local(rank, x)[0]):
        jac(prob.x0)
        assert len(body.graphs) == 1
        torch.testing.assert_close(other(prob.x0), want)
        assert len(body.graphs) == 0


def test_cli_retrieve_runs_its_jacobians_eagerly(forced, tmp_path):
    """The CLI's retrieve makes one retrieval of a scene it builds: its
    Jacobians run eagerly, with the route forced as on the card."""
    toml = tmp_path / "one.toml"
    toml.write_text(MESH_TOML)
    before = dict(GRAPH_COUNTS)
    assert cli.main(["retrieve", str(toml), "--device", "cpu", "-o",
                     f"run.output_dir={tmp_path / 'out'}"]) == 0
    assert forced.made == []
    assert _counts(before) == dict.fromkeys(GRAPH_COUNTS, 0)


def test_chunked_and_reverse_never_take_the_route(forced, slice_scene):
    before = dict(GRAPH_COUNTS)
    cfg, _, prob, _ = _build({**SLICE, "retrieval.jac_chunk": "3"},
                             slice_scene)
    jac = cli.make_jacobian(cfg, prob.fwd_flat, int(prob.x0.shape[0]),
                            int(slice_scene.nu.shape[0]), CPU)
    for _ in range(2):
        torch.testing.assert_close(
            jac(prob.x0), torch.func.jacfwd(prob.fwd_flat)(prob.x0))
    rev = cli.retrieval_problem(cfg, slice_scene, cli.KERNELS, "rev")
    x = rev.x0.clone().requires_grad_()
    (g,) = torch.autograd.grad(rev.fwd_flat(x).sum(), x)
    assert bool(torch.isfinite(g).all())
    # A Jacobian of x that requires grad runs eagerly too.
    _, _, prob, jac = _build(SLICE, slice_scene)
    jac(prob.x0.clone().requires_grad_())
    assert forced.made == []
    assert _counts(before) == dict.fromkeys(GRAPH_COUNTS, 0)


MESH_TOML = """\
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
n_channels = 16
[retrieval]
max_iter = 2
"""


def test_mesh_retrieve_never_takes_the_route(tmp_path):
    """The CLI's retrieve on the (1, 1, 2) mesh of 2 gloo ranks, the route
    forced as on the card: the mesh's forward bodies capture (their own
    graphs), the Jacobian's graph counts stay 0."""
    toml = tmp_path / "mesh.toml"
    toml.write_text(MESH_TOML)
    got = cases.run(tmp_path / "ranks", 2, cases.jacobian_route_mesh_case,
                    str(toml), str(tmp_path / "out"), _free_port(),
                    join_group=False)
    for rank_counts, mesh_graphs in got:
        assert rank_counts == dict.fromkeys(GRAPH_COUNTS, 0)
        assert mesh_graphs > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_jacobian_makes_no_host_read_or_copy(case):
    """After one call (which stages what a forward keeps: a node grid's
    matrix), the Jacobian of each configuration reads no tensor value on
    the host and makes no tensor from host data."""
    _, _, prob, _ = _build(CASES[case])
    prob.fwd_flat(prob.x0)
    with cases._host_reads_mode(cases.HOST_READS + HOST_DATA) as mode:
        torch.func.jacfwd(prob.fwd_flat)(prob.x0)
    assert mode.seen == []


@pytest.mark.parametrize("n_lev", [2, 7, 33])
def test_segment_order_is_the_host_order(n_lev):
    """The device-built segment order equals the host's of before: limb
    near side top to 0 then far side 0 to top, nadir top to 0; int64."""
    from spectrobot_tpu_torch.data.atmosphere import (
        MARS, mars_standard_atmosphere)
    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=60e3, device=CPU)
    n_lay = n_lev - 1
    limb = limb_path_cg(atm, ["CO2"], torch.as_tensor([8e3, 25e3]), MARS, 2)
    nadir = nadir_path_cg(atm, ["CO2"], torch.as_tensor([1.0, 1.5]), 2)
    want_limb = torch.as_tensor(np.concatenate([np.arange(n_lay)[::-1],
                                                np.arange(n_lay)]))
    want_nadir = torch.as_tensor(np.arange(n_lay)[::-1].copy())
    assert limb.seg_layer.dtype == nadir.seg_layer.dtype == torch.int64
    assert torch.equal(limb.seg_layer, want_limb)
    assert torch.equal(nadir.seg_layer, want_nadir)
    assert (limb.seg_count, nadir.seg_count) == (2 * n_lay, n_lay)


def test_a_scene_takes_its_problems_and_graphs_with_it(forced):
    _, scene, prob, jac = _build(SLICE)
    jac(prob.x0)
    jac(prob.x0)
    refs = weakref.ref(scene), weakref.ref(prob.fwd_flat)
    body = weakref.ref(state._GRAPHED[prob.fwd_flat])
    assert len(body().graphs) == 1
    del scene, prob, jac
    gc.collect()
    assert all(r() is None for r in refs) and body() is None


class _Event:
    """A stand-in for ``torch.cuda.Event``: each record reads the next
    tick of a clock, ``elapsed_time`` their difference."""
    ticks = 0

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing and external
        self.t = None

    def record(self, stream=None):
        _Event.ticks += 1
        self.t = _Event.ticks

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_captured_spans_replay_as_records(monkeypatch):
    """Spans met inside a capture become timing events (profiler or not);
    a replay under a profiler adds one record each, nested as captured,
    the outermost under the span open at the replay, with the events'
    device time and no host time; without a profiler it adds none."""
    from torch.profiler import ProfilerActivity, profile

    from spectrobot_tpu_torch.utils import profiling
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    with profiling.capturing_spans() as captured:
        with profiling.annotate("a"):
            with profiling.annotate("b"):
                pass
        with profiling.annotate("c"):
            pass
    assert [(c["name"], c["parent"]) for c in captured] == [
        ("a", None), ("b", 0), ("c", None)]
    assert profiling.annotate("x").__class__.__name__ == "nullcontext"
    profiling.reset_spans()
    profiling.replayed_spans(captured)
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("spectrobot.jacobian"):
            profiling.replayed_spans(captured)
    recs = profiling.spans()
    profiling.reset_spans()
    by_name = {r["name"]: r for r in recs}
    assert [r["name"] for r in recs] == ["spectrobot.jacobian", "a", "b",
                                         "c"]
    jac = by_name["spectrobot.jacobian"]
    assert by_name["a"]["parent"] == by_name["c"]["parent"] == jac["id"]
    assert by_name["b"]["parent"] == by_name["a"]["id"]
    assert [by_name[n]["device_ms"] for n in "abc"] == [3.0, 1.0, 1.0]
    assert all(by_name[n]["host_ms"] is None for n in "abc")
