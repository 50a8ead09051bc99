"""The plain reference against the port's own plain path on the CPU at a
small size (the port's kernels run their plain versions there): the
forward cell's spectra, the retrieval's spectra and Jacobian, and the
TF32 rounding of the control."""

import numpy as np
import pytest
import torch

from spectrobench import manifest
from spectrobench.inputs import make_inputs
from spectrobench.reference import physics
from spectrobench.tests.conftest import SMALL


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    man = manifest.load()
    inp = make_inputs(manifest.config_path(man, "mars15_lte"),
                      manifest.traffic("forward"), 17,
                      str(tmp_path_factory.mktemp("in")), SMALL)
    from spectrobot_tpu_torch import cli
    scene = cli.build_scene(inp.cfg, torch.device("cpu"))
    return inp, cli, scene


def test_forward_matches_the_port(small):
    inp, cli, scene = small
    fwd = cli.scene_forward(inp.cfg, scene)
    for a in inp.pool[:3]:
        state = {"T": torch.as_tensor(a["T"]),
                 "ln_vmr": {"CO2": torch.log(torch.as_tensor(a["vmr"]))}}
        y = fwd(state).double().numpy()
        ref = physics.forward(inp.scene, a["T"], a["vmr"], "float32",
                              "cpu", torch.float64).double().numpy()
        assert y.shape == ref.shape
        assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5


def test_retrieval_forward_and_jacobian_match_the_port(small):
    inp, cli, scene = small
    prob = cli.retrieval_problem(inp.cfg, scene)
    x = prob.x0 + torch.linspace(-3.0, 3.0, prob.x0.shape[0])
    v = np.random.default_rng(0).standard_normal(x.shape[0])
    y = prob.fwd_flat(x).double().numpy()
    K = torch.func.jacfwd(prob.fwd_flat)(x).double().numpy()
    vmr = inp.scene.atm["vmr_CO2"]
    ref, dref = (a.double().numpy() for a in physics.jvp(
        inp.scene, x.double().numpy(), vmr, v, np.zeros_like(vmr),
        "float32", "cpu", torch.float32))
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5
    assert np.abs(K @ v - dref).max() / np.abs(dref).max() < 1e-5


def test_the_control_rounds_products_to_tf32():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0e-5,
                      float("inf")], dtype=torch.float32)
    r = physics.to_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2.0 ** -9 and r[3] == float("inf")
    bits = physics.to_tf32(torch.randn(1000)).view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0
    a, b = torch.randn(8, 64), torch.randn(64, 5)
    got = physics.matmul(a, b, "tf32")
    want = physics.to_tf32(a) @ physics.to_tf32(b)
    torch.testing.assert_close(got, want)
    assert (got - a @ b).abs().max() > 0
