"""The mesh bodies' CUDA-graph route (spectrobot_tpu_torch/parallel/
graphed.py) on the CPU, where no graph is made:

- the input-kind rule: constants take the graph route, a jvp tangent, a
  vmap batch, a requires_grad input or an active transform the eager
  body; CPU tensors never the graph route;
- GraphedBody's bookkeeping with a stand-in for the capture (the route
  forced as on the card): the first call of a key runs the body and
  captures, later calls of the key replay, other shapes or arguments
  capture anew, non-constant calls run the body;
- the launch counts a replay adds, and their reading from a profiler
  trace's kernel names;
- a capture takes its streams' arrival counters and scratch out of the
  launches' per-stream cache (kernels/launch.py);
- on 2 gloo ranks, the nu-halo (limb and nadir), psum and K3 halo bodies
  of a non-LTE scene with the continuum read no tensor value on the host
  (which would stop their capture on the card), and through GraphedBody
  with torch.cuda's graphs made to raise they run eagerly and bit-equal
  to the body.

The graphs themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 6c)."""

import os
from collections import Counter

import pytest
import torch

from spectrobot_tpu_torch.kernels import launch
from spectrobot_tpu_torch.parallel import graphed

import torch_mesh_cases as cases

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "examples", "mars_limb.toml")
# Config 3 (non-LTE CO2 4.3 um) with the continuum, cut to a small grid.
OVERRIDES = {"grid.nu_min": "2280.0", "grid.nu_max": "2400.0",
             "grid.n_points": "256", "scene.n_levels": "9",
             "lines.source": "synthetic:co2_43um", "nlte.enabled": "true",
             "nlte.t_vib": "demo:co2_pump", "cia.enabled": "true",
             "compute.dtype": "float64"}


def _kinds(fn):
    """What ``fn(v)`` sees of an input of each kind: {kind: value}."""
    x = torch.linspace(0.0, 1.0, 3)
    seen = {}

    def under(kind):
        def f(v):
            seen[kind] = fn(v, x)
            return v * 2.0
        return f

    under("constant")(x)
    under("requires_grad")(x.clone().requires_grad_())
    torch.func.jvp(under("jvp"), (x,), (torch.ones_like(x),))
    torch.func.vmap(under("vmap"))(x[None].repeat(2, 1))
    torch.func.jacfwd(under("jacfwd"))(x)
    with torch.autograd.forward_ad.dual_level():
        under("dual")(torch.autograd.forward_ad.make_dual(
            x, torch.ones_like(x)))
    return seen


def test_constant_call_takes_constants_only():
    """The input itself, and a constant beside it inside a transform."""
    got = _kinds(lambda v, x: (graphed.constant_call([v]),
                               graphed.constant_call([x])))
    assert got == {"constant": (True, True), "requires_grad": (False, True),
                   "jvp": (False, False), "vmap": (False, False),
                   "jacfwd": (False, False), "dual": (False, True)}


def test_cpu_tensors_never_take_the_graph_route():
    got = _kinds(lambda v, x: graphed.graph_route([v]))
    assert got == dict.fromkeys(got, False) and len(got) == 6
    assert not graphed.graph_route([])


class _Capture:
    """A stand-in for graphed._Graph: records the capture's leaves and
    replays by the body's arithmetic."""
    made = []

    def __init__(self, body, leaves, spec, spans=False):
        self.leaves, self.pool_bytes = leaves, 0
        self.graph = type("G", (), {"reset": lambda s: None})()
        _Capture.made.append(self)

    def replay(self, tensors):
        return tensors[0] * 2.0


def test_graphed_body_captures_once_a_key(monkeypatch):
    """The route as on the card (constants): one capture a key, the first
    call of a key eager, later calls replays; non-constants eager."""
    monkeypatch.setattr(graphed, "graph_route", graphed.constant_call)
    monkeypatch.setattr(graphed, "_Graph", _Capture)
    _Capture.made = []
    ran = []

    def body(a, b=None, *, side=None):
        ran.append(side)
        return a * 2.0

    f = graphed.GraphedBody(body)
    x = torch.ones(3)
    for a, kw in ((x, {}), (x + 1.0, {}), (torch.ones(4), {}),
                  (x, {"b": 1.0}), (x, {"b": 1.0}), (x, {"b": 2.0}),
                  (x.double(), {})):
        assert torch.equal(f(a, **kw), a * 2.0)
    assert len(ran) == 5 and ran == [None] * 5
    assert len(f.graphs) == len(_Capture.made) == 5 and f.replays == 2
    # Non-constants run the body and capture nothing.
    _kinds(lambda v, c: f(v))
    assert len(f.graphs) == 5 and f.replays == 3 and len(ran) == 10
    f.release()
    assert f.graphs == {}


def test_launch_counts_add_and_take_back():
    """A capture's increments taken back and added again, as
    ``graphed._Graph`` does with ``launch.LAUNCHES``, over every kernel."""
    before = launch.LAUNCHES.copy()
    delta = Counter({k: i + 1 for i, k in enumerate(launch.KERNELS.values())})
    launch.LAUNCHES.update(delta)
    try:
        assert launch.LAUNCHES == before + delta
        assert launch.LAUNCHES - before == delta
    finally:
        launch.LAUNCHES.subtract(delta)
    assert launch.LAUNCHES == before


def test_kernel_launches_read_from_trace_names():
    """A trace's kernels counted by their __global__ names: two K1
    launches, one K3, none of a kernel whose name is a near miss."""
    names = ["opacity_batch_kernel(float const*, float*)",
             "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
             "opacity_single_kernel(float const*, int)",
             "void at::native::vectorized_elementwise_kernel<4>",
             "opacity_batch_kernel(float const*, float*)",
             "sum_segments_kernel(float const*, float*)"]
    got = launch.kernel_launches(names)
    assert set(got) == set(launch.KERNELS.values())
    assert got == {k: {"opacity_batch_kernel": 2,
                       "opacity_single_kernel": 1}.get(k, 0) for k in got}


def test_traced_launches_on_the_cpu():
    """halo_overlap.traced_launches returns the call's value and, with no
    device events on the CPU, no launch."""
    from spectrobot_tpu_torch import halo_overlap as ho
    x = torch.arange(4.0)
    got, out = ho.traced_launches(lambda: x * 2.0, torch.device("cpu"))
    assert torch.equal(out, x * 2.0)
    assert got == dict.fromkeys(launch.KERNELS.values(), 0)


class _Stream:
    def __init__(self, handle):
        self.cuda_stream = handle


def test_capture_takes_its_streams_counters():
    """The arrival counters and scratch cached for a capture's streams
    leave the cache, whichever kernel owns them; those of other streams
    stay."""
    dev = torch.device("cpu")
    saved = dict(launch._PER_STREAM)
    try:
        mine = launch.arrival_counters("opacity_single", dev, 11, 4)
        other = launch.arrival_counters("opacity_single", dev, 12, 4)
        also_mine = launch.scratch("dma_halo", dev, 13, 4)
        taken = launch.take([_Stream(11), _Stream(13)])
        assert len(taken) == 2
        assert {id(t) for t in taken} == {id(mine), id(also_mine)}
        assert launch.arrival_counters("opacity_single", dev, 11, 4) \
            is not mine
        assert launch.arrival_counters("opacity_single", dev, 12, 4) \
            is other
    finally:
        launch._PER_STREAM.clear()
        launch._PER_STREAM.update(saved)


@pytest.fixture(scope="module")
def route(tmp_path_factory):
    return cases.run(tmp_path_factory.mktemp("graph_route"), 2,
                     cases.graph_route_case, SCENE, OVERRIDES)


BODIES = {"halo limb", "halo nadir", "psum limb", "K3 halo"}


def test_mesh_bodies_read_nothing_on_the_host(route):
    for r in route:
        assert r["probe"] == ["aten::_local_scalar_dense"]
        assert set(r["reads"]) == BODIES
        assert r["reads"] == dict.fromkeys(BODIES, [])


def test_cpu_mesh_bodies_never_reach_cuda_graphs(route):
    for r in route:
        assert r["cpu_route"] == dict.fromkeys(BODIES, (0, 0, True))
