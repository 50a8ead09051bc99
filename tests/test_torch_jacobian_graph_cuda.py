"""The single-card Jacobian replayed from one CUDA graph
(``retrieval.state.jacobian_graphed``, through ``cli.make_jacobian``) on
the card (marker ``cuda``; skips without a GPU and nvcc):

- on a limb slice, config 3 (non-LTE), the composed scene (non-LTE, CIA,
  FOV), the slice in float64, on a node grid and through the table, the
  first call (eager, then captured) and the replays are bit-equal to the
  eager ``torch.func.jacfwd`` at the same state, a rebuilt problem of the
  same scene replays the same graph, and a replay's profiler trace shows
  K1 and K2 launched as often as the eager call's;
- under ``torch.profiler`` a replay records the forward's five phases,
  each with a device time, under its ``spectrobot.jacobian`` span;
- two forwards' Jacobians keep their graphs side by side within the
  guard's limit, and release the least recently called one's past it;
- the chunked Jacobian stays eager, and releases the graphs held beside
  it.

Run on the card with ``python -m pytest -m cuda tests/``."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spectrobot_tpu_torch import cli
from spectrobot_tpu_torch.retrieval.state import GRAPH_COUNTS
from spectrobot_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

SLICE = {"grid.nu_min": "660.0", "grid.nu_max": "674.0",
         "grid.n_points": "512", "scene.n_levels": "9",
         "geometry.tangent_heights_km": "8.0,25.0,40.0",
         "geometry.n_sub": "2", "instrument.enabled": "true",
         "instrument.n_channels": "32"}
CONFIG3 = {**SLICE, "grid.nu_min": "2280.0", "grid.nu_max": "2400.0",
           "lines.source": "synthetic:co2_43um", "nlte.enabled": "true",
           "nlte.t_vib": "demo:co2_pump"}
CASES = {"slice": SLICE, "config3": CONFIG3,
         "composed": {**CONFIG3, "cia.enabled": "true",
                      "instrument.fov_fwhm_km": "3.0",
                      "instrument.fov_n_fine": "8"},
         "float64": {**SLICE, "compute.dtype": "float64"},
         "nodes": {**SLICE, "retrieval.n_nodes": "4"},
         "table": {**SLICE, "compute.use_lut": "true"}}
PHASES = ("spectrobot.forward.path", "spectrobot.forward.prologue",
          "spectrobot.forward.line_sum", "spectrobot.forward.epilogue",
          "spectrobot.forward.ils")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the graph is captured only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(overrides, device):
    """(cfg, scene, its retrieval problem, the Jacobian callable)."""
    cfg = cli.load_config(None, overrides)
    scene = cli.build_scene(cfg, device)
    prob = cli.retrieval_problem(cfg, scene, cli.select_engine(cfg, device))
    jac = cli.make_jacobian(cfg, prob.fwd_flat, int(prob.x0.shape[0]),
                            int(scene.nu.shape[0]), device)
    return cfg, scene, prob, jac


def _traced(fn):
    """(fn(), the launches of K1 and K2 its profiler trace shows)."""
    from spectrobot_tpu_torch.halo_overlap import traced_launches
    seen, out = traced_launches(fn, torch.device("cuda"))
    return out, (seen["opacity_batch_kernel"], seen["basis_batch_kernel"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_jacobian_is_bit_equal_to_eager(cuda, case):
    cfg, scene, prob, jac = _problem(CASES[case], cuda)
    f = prob.fwd_flat
    x_a = prob.x0
    x_b = prob.x0 + torch.linspace(0.5, 2.0, prob.x0.shape[0],
                                   dtype=prob.x0.dtype, device=cuda)
    before = dict(GRAPH_COUNTS)
    first = jac(x_a)
    (K_a, n_replay), K_b = _traced(lambda: jac(x_a)), jac(x_b)
    eager_a, n_eager = _traced(lambda: torch.func.jacfwd(f)(x_a))
    eager_b = torch.func.jacfwd(f)(x_b)
    assert torch.equal(first, eager_a)
    assert torch.equal(K_a, eager_a) and torch.equal(K_b, eager_b)
    assert not torch.equal(K_a, K_b)
    assert n_replay == n_eager
    assert n_eager == ((0, 0) if case == "table" else (1, 1))
    # The problem rebuilt, as every scan of the benchmark rebuilds it: the
    # same forward, the same graph.
    prob2 = cli.retrieval_problem(cfg, scene, cli.select_engine(cfg, cuda))
    assert prob2.fwd_flat is f
    jac2 = cli.make_jacobian(cfg, prob2.fwd_flat, int(x_a.shape[0]),
                             int(scene.nu.shape[0]), cuda)
    assert torch.equal(jac2(x_b), eager_b)
    got = {k: GRAPH_COUNTS[k] - before[k] for k in GRAPH_COUNTS}
    assert got == {"jacobian_graph_captures": 1, "jacobian_graph_replays": 3}


@pytest.mark.parametrize("case", ["slice", "composed"])
def test_replay_records_the_phases_under_the_profiler(cuda, case):
    _, _, prob, jac = _problem(CASES[case], cuda)
    jac(prob.x0)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        jac(prob.x0)
        jac(prob.x0 + 1.0)
    recs = profiling.spans()
    profiling.reset_spans()
    by_id = {r["id"]: r for r in recs}

    def jacobian_of(r):
        p = r["parent"]
        while p in by_id and by_id[p]["name"] != "spectrobot.jacobian":
            p = by_id[p]["parent"]
        return p

    jacs = [r for r in recs if r["name"] == "spectrobot.jacobian"]
    assert len(jacs) == 2
    for j in jacs:
        under = [r for r in recs if r["name"] in PHASES
                 and jacobian_of(r) == j["id"]]
        assert sorted(r["name"] for r in under) == sorted(PHASES)
        assert all(r["device_ms"] > 0 and r["host_ms"] is None
                   for r in under)
        assert sum(r["device_ms"] for r in under) <= j["device_ms"]


def test_forwards_keep_their_graphs_within_the_guard(cuda, monkeypatch):
    """The kernels' and the plain engine's Jacobians of one scene, called
    in turns, keep both graphs (two small pools, far within the guard's
    half of the card) and replay them bit-equal; with the limit cut to the
    kernels' own Jacobian, a call of it releases the plain engine's
    graph, which captures again at its next call."""
    from spectrobot_tpu_torch.ops.cuda_basis import PLAIN
    from spectrobot_tpu_torch.retrieval import state
    cfg, scene, prob, jac = _problem(SLICE, cuda)
    prob2 = cli.retrieval_problem(cfg, scene, PLAIN)
    n_x, n_fine = int(prob.x0.shape[0]), int(scene.nu.shape[0])
    jac2 = cli.make_jacobian(cfg, prob2.fwd_flat, n_x, n_fine, cuda)
    held = lambda: [len(state._GRAPHED[p.fwd_flat].graphs)
                    for p in (prob, prob2)]
    before = dict(GRAPH_COUNTS)
    for x in (prob.x0, prob.x0 + 1.0, prob.x0 + 2.0):
        assert torch.equal(jac(x), torch.func.jacfwd(prob.fwd_flat)(x))
        assert torch.equal(jac2(x), torch.func.jacfwd(prob2.fwd_flat)(x))
        assert held() == [1, 1]
    got = {k: GRAPH_COUNTS[k] - before[k] for k in GRAPH_COUNTS}
    assert got == {"jacobian_graph_captures": 2, "jacobian_graph_replays": 4}
    own = max(state._held(state._GRAPHED[prob.fwd_flat]),
              cli.jacobian_bytes(cfg, n_x, n_fine))
    monkeypatch.setattr(cli, "jacobian_limit", lambda device: own + 1)
    jac_cut = cli.make_jacobian(cfg, prob.fwd_flat, n_x, n_fine, cuda)
    x = prob.x0 + 3.0
    assert torch.equal(jac_cut(x), torch.func.jacfwd(prob.fwd_flat)(x))
    assert held() == [1, 0]
    before = dict(GRAPH_COUNTS)
    assert torch.equal(jac2(x), torch.func.jacfwd(prob2.fwd_flat)(x))
    assert held() == [1, 1]
    got = {k: GRAPH_COUNTS[k] - before[k] for k in GRAPH_COUNTS}
    assert got == {"jacobian_graph_captures": 1, "jacobian_graph_replays": 0}


def test_chunked_jacobian_stays_eager(cuda):
    """The chunked Jacobian replays nothing, and releases the graph that
    another forward's Jacobian holds before it runs."""
    from spectrobot_tpu_torch.retrieval import state
    _, _, held_prob, held_jac = _problem(SLICE, cuda)
    held_jac(held_prob.x0)
    assert len(state._GRAPHED[held_prob.fwd_flat].graphs) == 1
    cfg, scene, prob, _ = _problem({**SLICE, "retrieval.jac_chunk": "4"},
                                   cuda)
    jac = cli.make_jacobian(cfg, prob.fwd_flat, int(prob.x0.shape[0]),
                            int(scene.nu.shape[0]), cuda)
    before = dict(GRAPH_COUNTS)
    K = [jac(prob.x0) for _ in range(3)]
    assert GRAPH_COUNTS == before
    assert len(state._GRAPHED[held_prob.fwd_flat].graphs) == 0
    torch.testing.assert_close(K[2], torch.func.jacfwd(prob.fwd_flat)(
        prob.x0))
