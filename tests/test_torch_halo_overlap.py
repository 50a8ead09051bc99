"""The nu-halo exchange issued before the own line sum and waited on after
it (spectrobot_tpu_torch/parallel/collectives.py:ring_exchange_start), and
the trace tool spectrobot_tpu_torch/halo_overlap.py, on the CPU:

- the two-hop nu-halo sharded forward at (1, 1, 4), limb and nadir, in
  float64 against JAX's sharded_radiance_fn on the emulated mesh and the
  port's single-device forward, and its make_sharded_oe Jacobian against
  the JAX mesh retrieval's;
- at 2 and 4 gloo ranks the exchange bit-equal to ring_shift, its refusal
  of a jvp tangent, a vmap batch and a requires_grad input, and the
  sharded forward and both halo accumulations bit-equal to the same sums
  in the order of the synchronous shift, also when the same function runs
  a second forward on other line parameters (which catches a buffer kept
  from one forward to the next going stale);
- the tool's analysis and host marks (of the eager issue order and of a
  graph replay) on synthetic event lists, its traffic argument
  against the reference's, and the tool end to end on 2 gloo ranks."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band, co_fundamental
from spectrobot_tpu.ops.strengths import device_lines_from_linelist
from spectrobot_tpu.parallel.mesh import make_mesh
from spectrobot_tpu.parallel.oe import make_sharded_oe
from spectrobot_tpu.retrieval.state import flatten_state, make_state
from spectrobot_tpu_torch import halo_overlap as ho

import torch_mesh_cases as cases
from test_torch_halo import _np, _scene as _halo_scene
from test_torch_sharded import _assemble, _jax_sharded, _scene, _single_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HALO_CUTOFF = 10.0     # the halo accumulation's: 100 / 4 cm-1 shards
OE_CUTOFF = 5.0        # 45 / 4 cm-1 shards
SPECIES = ["CO2", "CO"]


def _messages(world, L=40, seed=4):
    """Each rank's two messages: 8 float64 rows and 3 int64 rows."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((world, 8, L)),
            rng.integers(-5, 1000, (world, 3, L)))


def _oe_scene():
    """The sharded retrieval's limb scene (test_torch_mesh_retrieval's
    without its instrument function) as numpy, and its JAX objects."""
    atm = mars_standard_atmosphere(n_lev=6, z_top=60e3)
    co = co_fundamental(j_max=6)
    co.nu0[:] = co.nu0 - 2143.27 + 655.0
    dl = device_lines_from_linelist(co2_15um_band(j_max=8).concat(co),
                                    [(2, 1), (5, 1)], dtype=jnp.float64)
    d = {k: np.array(getattr(atm, k)) for k in ("z", "p", "T", "n")}
    d["vmr"] = {k: np.array(v) for k, v in atm.vmr.items()}
    return {"atm": d, "species": SPECIES, "nu": np.linspace(645.0, 690.0, 256),
            "h_t": np.array([6e3, 14e3, 22e3, 30e3]),
            "lines": {k: np.array(v) for k, v in dl._asdict().items()}
            }, (atm, dl)


def _jax_oe(sc, jx, shape):
    """(forward, Jacobian) of the JAX mesh retrieval at the prior."""
    atm, dl = jx
    mesh = make_mesh(shape, jax.devices()[:int(np.prod(shape))])
    state0 = make_state(atm, ["CO"])
    oe = make_sharded_oe(
        mesh, atm, dl, jnp.asarray(sc["nu"]), SPECIES, J_MARS,
        jnp.asarray(sc["h_t"]), state_template=state0, n_sub=2,
        cutoff_cm1=OE_CUTOFF, chunk=128, nu_halo=True)
    x0, _ = flatten_state(state0)
    return np.asarray(oe.forward_flat(x0)), np.asarray(oe.jacobian(x0))


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    world = request.param
    shape = (1, 1, world)
    scenes = {m: _scene(m) for m in ("limb", "nadir")}
    oe_sc = _oe_scene()
    halo_sc = _halo_scene()
    halo_in = (halo_sc[2], halo_sc[0], _np(halo_sc[1]), HALO_CUTOFF)
    oe_cases = ([("halo", shape, {"nu_halo": True, "cutoff_cm1": OE_CUTOFF},
                  oe_sc[0], np.ones(1024), np.ones(1024))]
                if world == 4 else [])
    got = cases.run(tmp_path_factory.mktemp(f"exchange{world}"), world,
                    cases.exchange_case, _messages(world),
                    [(m, shape, scenes[m][0]) for m in scenes], halo_in,
                    oe_cases)
    return world, scenes, oe_sc, got


def test_exchange_equals_ring_shift(ranks):
    """Every hop's received reals and ints bit-equal to ring_shift's."""
    world, _, _, got = ranks
    msgs = _messages(world)
    for r in range(world):
        for hop, shift in enumerate((1, -1, 2)):
            for m in range(2):
                a = got[r]["exchange"][hop][m]
                assert a.dtype == got[r]["ring_shift"][hop][m].dtype
                assert torch.equal(a, got[r]["ring_shift"][hop][m])
                np.testing.assert_array_equal(
                    a.numpy(), msgs[m][(r - shift) % world])


def test_exchange_refuses_what_is_not_constant(ranks):
    world, _, _, got = ranks
    for r in range(world):
        assert got[r]["refuses"] == {"jvp": True, "vmap": True,
                                     "requires_grad": True}


@pytest.mark.parametrize("mode", ["limb", "nadir"])
def test_sharded_bit_equal_to_synchronous_order(ranks, mode):
    world, _, _, got = ranks
    for r in range(world):
        I, _, parent = got[r]["sharded"][mode]
        assert torch.equal(I, parent)


def test_halo_accumulations_bit_equal_to_synchronous_order(ranks):
    world, _, _, got = ranks
    for r in range(world):
        plain, kernel, (p_plain, p_kernel) = got[r]["halo"]
        assert torch.equal(plain, p_plain)
        assert torch.equal(kernel, p_kernel)


@pytest.mark.parametrize("mode", ["limb", "nadir"])
def test_second_forward_on_other_lines_is_its_own(ranks, mode):
    """The mesh function called twice, the second time on other line
    parameters: each forward bit-equal to the synchronous order on its own
    lines."""
    world, _, _, got = ranks
    for r in range(world):
        I, _, parent = got[r]["sharded"][mode]
        I2, parent2 = got[r]["sharded_again"][mode]
        assert torch.equal(I2, parent2)
        assert not torch.equal(I2, I)


def test_second_halo_accumulation_on_other_lines_is_its_own(ranks):
    world, _, _, got = ranks
    for r in range(world):
        plain, kernel, _ = got[r]["halo"]
        plain2, kernel2, (p_plain, p_kernel) = got[r]["halo_again"]
        assert torch.equal(plain2, p_plain)
        assert torch.equal(kernel2, p_kernel)
        assert not torch.equal(plain2, plain)
        assert not torch.equal(kernel2, kernel)


@pytest.mark.parametrize("ranks", [4], indirect=True)
@pytest.mark.parametrize("mode", ["limb", "nadir"])
def test_two_hop_sharded_matches(ranks, mode):
    """The (1, 1, 4) mesh: two hops a forward (the one-hop shapes are
    tests/test_torch_sharded.py's)."""
    _, scenes, _, got = ranks
    sc, jx = scenes[mode]
    shape = (1, 1, 4)
    blocks = [(g["sharded"][mode][0], g["sharded"][mode][1], None)
              for g in got]
    I = _assemble(blocks, shape, sc["cg"]["u"].shape[0], len(sc["nu"]))
    for ref in (_single_device(sc), _jax_sharded(shape, True, sc, jx)):
        np.testing.assert_allclose(I, ref, rtol=1e-10,
                                   atol=np.abs(ref).max() * 1e-12)


@pytest.mark.parametrize("ranks", [4], indirect=True)
def test_two_hop_jacobian_matches_jax_mesh(ranks):
    """make_sharded_oe's jacfwd through the two-hop exchange against the
    JAX mesh retrieval at (1, 1, 4)."""
    world, _, (sc, jx), got = ranks
    y_ref, K_ref = _jax_oe(sc, jx, (1, 1, 4))
    for r in range(world):
        fwd, _, K, _ = got[r]["oe"]["halo"]
        np.testing.assert_allclose(fwd.numpy(), y_ref, rtol=1e-10,
                                   atol=np.abs(y_ref).max() * 1e-12)
        np.testing.assert_allclose(K.numpy(), K_ref, rtol=1e-10,
                                   atol=np.abs(K_ref).max() * 1e-12)


# ---------------------------------------------------------------------------
# the tool's analysis, traffic and run
# ---------------------------------------------------------------------------

K1 = "void opacity_batch_kernel<false>(float const*, ...)"
SENDRECV = "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"
ALLREDUCE = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)"


def test_schedule_overlapped():
    """The exchange on its own stream, issued first, across the
    prologue and K1: both overlap it; the part of it past K1 is
    exposed."""
    work = [("elementwise_kernel", 100.0, 110.0, 7),
            (SENDRECV, 105.0, 170.0, 20),
            (K1, 112.0, 150.0, 7),
            (K1, 175.0, 200.0, 7),
            (ALLREDUCE, 201.0, 204.0, 21)]
    s = ho.schedule(work)
    assert s["n_exchange_launches"] == 1
    assert s["exchange_start_us"] == 5.0 and s["exchange_end_us"] == 70.0
    assert s["kernels_overlapped_in_flight_window"] == 2
    assert s["exposed_exchange_us"] == pytest.approx(2.0 + 20.0)
    assert s["async_pairs_emitted"] is True
    assert s["busy_us"] == pytest.approx(10.0 + 60.0 + 25.0 + 3.0)
    assert s["line_all_reduce_us"] == pytest.approx(3.0)


def test_schedule_serialized():
    """The order of the synchronous shift: each exchange after the line
    sum before it; nothing runs beside them."""
    work = [(K1, 0.0, 40.0, 7), (SENDRECV, 41.0, 60.0, 20),
            (SENDRECV, 61.0, 70.0, 20), (K1, 71.0, 90.0, 7)]
    s = ho.schedule(work)
    assert s["n_exchange_launches"] == 2
    assert s["kernels_overlapped_in_flight_window"] == 0
    assert s["exposed_exchange_us"] == pytest.approx(28.0)
    assert s["async_pairs_emitted"] is False


def test_schedule_without_exchange_and_without_events():
    s = ho.schedule([(K1, 3.0, 9.0, 7), ("Memcpy DtoD", 9.0, 10.0, 7)])
    assert s["n_exchange_launches"] == 0
    assert s["exchange_start_us"] is None and s["exchange_end_us"] is None
    assert s["kernels_overlapped_in_flight_window"] == 0
    assert s["exposed_exchange_us"] == 0.0
    assert s["async_pairs_emitted"] is False
    assert all(v is None for v in ho.schedule([]).values())
    fwds = [{**ho.schedule([]), "window_us": w} for w in (1.0, 3.0)]
    summ = ho.summary(fwds)
    assert summ["window_us"] == 2.0 and summ["n_exchange_launches"] is None


def _event(name, start, end, dev=False, corr=0):
    """A profiler event as ``host_marks`` reads it."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, id=corr, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if dev else DeviceType.CPU)


def test_host_marks_of_the_issue_order():
    """The own sum's range launches a prologue kernel and K1; the
    exchange's issue range launches the send/receive kernel; every time
    from the forward's range start (1000 us); launches are matched to
    their kernels by correlation id."""
    from spectrobot_tpu_torch.parallel.collectives import (
        EXCHANGE_RANGE, OWN_SUM_RANGE)
    ev = [_event(OWN_SUM_RANGE, 1010.0, 1100.0),
          _event("cudaLaunchKernel", 1020.0, 1025.0, corr=7),
          _event("cudaLaunchKernel", 1090.0, 1095.0, corr=8),
          _event(EXCHANGE_RANGE, 1105.0, 1200.0),
          _event("cuLaunchKernelEx", 1180.0, 1190.0, corr=9),
          _event("elementwise_kernel", 1022.0, 1030.0, dev=True, corr=7),
          _event(K1, 1093.0, 1150.0, dev=True, corr=8),
          _event(SENDRECV, 1185.0, 1195.0, dev=True, corr=9),
          _event(K1, 5000.0, 5050.0, dev=True, corr=3)]
    m = ho.host_marks(ev, 1000.0, 1300.0)
    assert m == {"host_own_sum_start_us": 10.0,
                 "host_own_sum_first_launch_us": 20.0,
                 "host_exchange_issue_us": 105.0,
                 "host_exchange_launch_us": 180.0,
                 "exchange_device_start_us": 185.0,
                 "own_sum_device_end_us": 150.0,
                 "own_prologue_device_us": 8.0,
                 "own_line_sum_device_us": 57.0,
                 "host_replay_start_us": None,
                 "host_graph_launch_us": None}
    assert all(v is None for v in ho.host_marks(ev, 0.0, 5.0).values())


def test_host_marks_of_a_replay():
    """Under a replay (its range from 1010 us) the input copy and then one
    cudaGraphLaunch, whose kernels (one correlation id) are a stack of the
    messages, the prologue, K1 beside the send/receive kernel, and a hop's
    K1: the exchange's and the own sum's host marks are the replay's and
    the graph launch's; the own line sum is the graph's first K1, its
    prologue the graph's compute kernels that end before it."""
    from spectrobot_tpu_torch.parallel.graphed import REPLAY_RANGE
    ev = [_event(REPLAY_RANGE, 1010.0, 1100.0),
          _event("cudaLaunchKernel", 1015.0, 1020.0, corr=5),
          _event("cudaGraphLaunch", 1030.0, 1060.0, corr=6),
          _event("multi_tensor_apply_kernel", 1022.0, 1024.0, dev=True,
                 corr=5),
          _event("CatArrayBatchedCopy", 1062.0, 1063.0, dev=True, corr=6),
          _event("elementwise_kernel", 1063.0, 1070.0, dev=True, corr=6),
          _event(SENDRECV, 1064.0, 1072.0, dev=True, corr=6),
          _event(K1, 1071.0, 1120.0, dev=True, corr=6),
          _event(K1, 1121.0, 1130.0, dev=True, corr=6)]
    m = ho.host_marks(ev, 1000.0, 1300.0)
    assert m == {"host_own_sum_start_us": 10.0,
                 "host_own_sum_first_launch_us": 30.0,
                 "host_exchange_issue_us": 10.0,
                 "host_exchange_launch_us": 30.0,
                 "exchange_device_start_us": 64.0,
                 "own_sum_device_end_us": 120.0,
                 "own_prologue_device_us": 8.0,
                 "own_line_sum_device_us": 49.0,
                 "host_replay_start_us": 10.0,
                 "host_graph_launch_us": 30.0}


def test_traffic_argument_matches_reference():
    path = os.path.join(REPO, "benchmarks", "halo_overlap_aot.py")
    spec = importlib.util.spec_from_file_location("halo_overlap_aot", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert ho.traffic_argument() == ref.traffic_argument()
    kw = dict(R_loc=5, NL=32, n_out=1, n_fields=9)
    assert ho.traffic_argument(**kw) == ref.traffic_argument(**kw)


def test_tool_on_two_gloo_ranks(tmp_path):
    out = tmp_path / "ho.json"
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "spectrobot_tpu_torch.halo_overlap",
         "--device", "cpu", "--scene", "aot", "--ranks", "2",
         "--forwards", "2", "--walls", "1", "--json-out", str(out)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(out.read_text())
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == res
    assert res["topology"] == "cpu, gloo ranks" and res["n_ranks"] == 2
    assert res["traffic"]["config2_scale"] == ho.traffic_argument()
    (run,) = res["runs"]
    assert run["mesh"] == [1, 1, 2] and run["n_points"] == 512
    assert res["traffic"]["port"][0]["bytes_per_hop"] == run[
        "port_traffic"]["bytes_per_hop"] > 0
    assert [r["coord"]["nu"] for r in run["ranks"]] == [0, 1]
    for r in run["ranks"]:
        assert r["forward_wall_ms"]["clock"] == "host"
        assert r["vs_single_device"]["worst_ratio"] < 1e-12
        assert len(r["forwards"]) == 2
        for f in r["forwards"] + [r["summary"]]:
            assert all(f[k] is None for k in ho.SCHEDULE_KEYS)
            assert f["window_us"] > 0
