"""The fused RT epilogue kernel (csrc/rt_epilogue.cu, ops/cuda_epilogue.py)
on the card (marker ``cuda``; skips without a GPU and nvcc):

- the primal and the tangent against the composed epilogue (the plain
  version: ``optics_from_tau`` + ``layer_path_radiance`` and its vmapped
  ``torch.func.jvp``), in float32 and float64, at the benchmark cells'
  shapes (``mars15_lte``: 20 rays x 31 layers = 620 states, 32 columns,
  LTE; ``mars43_nlte_fov``: 40 x 32 = 1280 states, 33 columns, non-LTE),
  the tangents in K2's unfolded layout, and on a nadir ray set whose
  background has a tangent; the tangent in float64 also against the
  kernel's derivation in plain PyTorch (tests/epilogue_cases.py);
- float32 depths under a float64 atmosphere (the CLI forward's): float64
  sources and radiances, as the composed ops give, and the CLI forward
  through the kernel;
- K1's and K2's two amplitude rows are bit-equal in LTE, so the LTE
  epilogue may read the absorption row alone;
- the retrieval Jacobian hands the kernel K2's output in place (no copy:
  the wrapper makes no tensor operation but its output), in one launch,
  within float32 roundoff of the composed epilogue's Jacobian;
- a captured CUDA graph replays both launches bit-equal to eager calls.

Run on the card with ``python -m pytest -m cuda tests/``."""

import pytest
import torch

from epilogue_cases import CELLS
from epilogue_cases import case as cell_case
from epilogue_cases import coefficients, contract
from spectrobot_tpu_torch.forward import limb
from spectrobot_tpu_torch.kernels import launch
from spectrobot_tpu_torch.ops import cuda_epilogue as ce

pytestmark = pytest.mark.cuda

# Kernel against the composed epilogue, max |diff| over max |composed|: in
# float32 within the cells' fit_gap (1e-5) and mars15_lte's jac_gap (3e-5)
# limits; float64 to its roundoff.
PRIMAL_REL = {torch.float32: 1e-5, torch.float64: 1e-12}
TANGENT_REL = {torch.float32: 3e-5, torch.float64: 1e-12}
SLICE = {"grid.nu_min": "660.0", "grid.nu_max": "674.0",
         "grid.n_points": "2048", "scene.n_levels": "12",
         "scene.z_top_m": "60e3",
         "geometry.tangent_heights_km": "8.0,15.0,25.0,40.0",
         "instrument.enabled": "true", "instrument.fwhm_cm1": "0.4",
         "instrument.n_channels": "32"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def _case(dev, dtype, cell):
    if cell == "nadir":
        return cell_case(dev, dtype, 4, 24, 3000, 7, True, (600.0, 750.0),
                         seed=5, limb_path=False)
    return cell_case(dev, dtype, *CELLS[cell])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("cell", [*CELLS, "nadir"])
def test_kernel_matches_the_composed_epilogue(cuda, cell, dtype):
    prim, tan, _ = _case(cuda, dtype, cell)
    before = launch.LAUNCHES["rt_epilogue_kernel"]
    I = ce.radiance(*prim)
    dI = ce.radiance_tangent(*prim, *tan)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["rt_epilogue_kernel"] == before + 2
    I_ref = ce.composed_radiance(*prim)
    dI_ref = ce.composed_tangent(*prim, *tan)
    assert I.shape == I_ref.shape and dI.shape == dI_ref.shape
    assert I.dtype == dI.dtype == dtype
    e_I, e_dI = rel_err(I, I_ref), rel_err(dI, dI_ref)
    print(f"{cell} {dtype}: primal {e_I:.3e}, tangent {e_dI:.3e}")
    assert e_I <= PRIMAL_REL[dtype] and e_dI <= TANGENT_REL[dtype]
    assert torch.isfinite(dI).all()
    if dtype == torch.float64:
        e_d = rel_err(dI, contract(coefficients(*prim), *tan))
        print(f"{cell}: tangent vs the derivation {e_d:.3e}")
        assert e_d <= TANGENT_REL[dtype]


@pytest.mark.parametrize("cell", [*CELLS, "nadir"])
def test_a_float64_atmosphere_keeps_float64_sources(cuda, cell):
    """Float32 depths, T_air (and the background) float64: the radiance and
    its tangent in float64, within float32 roundoff of the composed ops'
    promotion of the same inputs."""
    prim, tan, _ = _case(cuda, torch.float32, cell)
    up = lambda t: None if t is None else t.double()
    prim = (*prim[:1], up(prim[1]), *prim[2:5], up(prim[5]))
    tan = (up(tan[0]), tan[1], tan[2], up(tan[3]))
    I = ce.radiance(*prim)
    dI = ce.radiance_tangent(*prim, *tan)
    assert I.dtype == dI.dtype == torch.float64
    e_I = rel_err(I, ce.composed_radiance(*prim))
    e_dI = rel_err(dI, ce.composed_tangent(*prim, *tan))
    print(f"{cell} float32 depths, float64 sources: primal {e_I:.3e}, "
          f"tangent {e_dI:.3e}")
    assert e_I <= PRIMAL_REL[torch.float32]
    assert e_dI <= TANGENT_REL[torch.float32]


def test_the_cli_forward_takes_the_kernel(cuda, monkeypatch):
    """The CLI forward (a float64 atmosphere over float32 depths): one
    fused epilogue call, one launch, float64 radiances within float32
    roundoff of the composed route's."""
    from spectrobot_tpu_torch import cli

    cfg = cli.load_config(None, SLICE)
    scene = cli.build_scene(cfg, cuda)
    engine = cli.select_engine(cfg, cuda)
    before = dict(limb.EPILOGUE_COUNTS)
    launches = launch.LAUNCHES["rt_epilogue_kernel"]
    I = cli.run_forward(cfg, scene, engine)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["rt_epilogue_kernel"] == launches + 1
    assert limb.EPILOGUE_COUNTS == {"fused": before["fused"] + 1,
                                    "composed": before["composed"]}
    monkeypatch.setattr(limb, "_on_card", lambda t: False)
    I_ref = cli.run_forward(cfg, scene, engine)
    assert I.dtype == I_ref.dtype == torch.float64
    assert rel_err(I, I_ref) <= PRIMAL_REL[torch.float32]


def test_wrapper_reads_the_tangent_in_place(cuda):
    """At mars43_nlte_fov's shape: the tangent call makes one tensor (its
    output) and no copy of K2's buffer, whose views it reads by their
    strides."""
    from torch.utils._python_dispatch import TorchDispatchMode

    prim, tan, k2 = cell_case(cuda, torch.float32,
                              *CELLS["mars43_nlte_fov"])
    assert not tan[1].is_contiguous() and tan[1].data_ptr() == k2.data_ptr()

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    ce.radiance_tangent(*prim, *tan)
    torch.cuda.synchronize()
    with Record() as rec:
        ce.radiance_tangent(*prim, *tan)
    assert set(rec.ops) <= {"aten.empty.memory_format", "aten.expand.default"}
    assert rec.ops.count("aten.empty.memory_format") == 1


def _slice_problem(dev, dtype="float32"):
    from spectrobot_tpu_torch import cli

    cfg = cli.load_config(None, {**SLICE, "compute.dtype": dtype})
    scene = cli.build_scene(cfg, dev)
    prob = cli.retrieval_problem(cfg, scene, cli.select_engine(cfg, dev))
    return cfg, scene, prob


def test_lte_rows_are_bit_equal_through_k1_and_k2(cuda):
    """The LTE prologue stacks one amplitude row twice: K1's two depth rows
    and K2's two tangent rows come out bit-equal, so the LTE epilogue reads
    the absorption row alone and loses nothing."""
    from spectrobot_tpu_torch.cli import _rays
    from spectrobot_tpu_torch.forward.geometry import limb_path_cg

    cfg, scene, prob = _slice_problem(cuda)
    heights = _rays(cfg, scene)["tangent_heights_m"]

    def depths(T):
        cg = limb_path_cg(prob.atm.with_temperature(T),
                          scene.species_names, heights, scene.planet,
                          cfg.geometry.n_sub)
        return limb.layer_tau_kernel(scene.nu_off, scene.lines, cg,
                                     scene.windows)

    T = prob.atm.T.clone()
    dtau, dtau_em = depths(T)
    J_tau, J_em = torch.func.jacfwd(depths)(T)
    assert torch.equal(dtau, dtau_em) and torch.equal(J_tau, J_em)
    assert float(dtau.abs().max()) > 0 and float(J_tau.abs().max()) > 0


def test_the_retrieval_jacobian_takes_one_launch(cuda, monkeypatch):
    """The CLI's retrieval Jacobian (``torch.func.jacfwd`` of the flat
    forward): one EpilogueTangent call of every column, on K2's output in
    place, and within float32 roundoff of the composed epilogue's
    Jacobian."""
    cfg, scene, prob = _slice_problem(cuda)
    seen = []
    tangent = ce.radiance_tangent

    def record(*a):
        seen.append((a[7].shape, a[7].stride(), a[7].is_contiguous()))
        return tangent(*a)

    monkeypatch.setattr(ce, "radiance_tangent", record)
    before = launch.LAUNCHES["rt_epilogue_kernel"]
    J = torch.func.jacfwd(prob.fwd_flat)(prob.x0)
    torch.cuda.synchronize()
    # The primal and the tangent.
    assert launch.LAUNCHES["rt_epilogue_kernel"] == before + 2
    n_x = int(prob.x0.shape[0])
    assert len(seen) == 1 and seen[0][0][0] == n_x and not seen[0][2]
    assert seen[0][1][-1] == 1
    monkeypatch.setattr(limb, "_on_card", lambda t: False)
    J_ref = torch.func.jacfwd(prob.fwd_flat)(prob.x0)
    assert launch.LAUNCHES["rt_epilogue_kernel"] == before + 2
    assert rel_err(J, J_ref) <= TANGENT_REL[torch.float32]


def test_graph_replays_bit_equal(cuda):
    prim, tan, k2 = cell_case(cuda, torch.float32, 6, 16, 2048, 5, True,
                              (2280.0, 2400.0), seed=2)
    eager = (ce.radiance(*prim), ce.radiance_tangent(*prim, *tan))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        before = launch.LAUNCHES["rt_epilogue_kernel"]
        with torch.cuda.graph(graph, stream=stream):
            out = (ce.radiance(*prim), ce.radiance_tangent(*prim, *tan))
    torch.cuda.current_stream().wait_stream(stream)
    assert launch.LAUNCHES["rt_epilogue_kernel"] == before + 2
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, e) for o, e in zip(out, eager))
    prim[2].mul_(0.5)                   # new depths and tangents in place
    k2.mul_(-2.0)
    graph.replay()
    again = (ce.radiance(*prim), ce.radiance_tangent(*prim, *tan))
    torch.cuda.synchronize()
    assert all(torch.equal(o, e) for o, e in zip(out, again))
    assert not torch.equal(out[1], eager[1])
