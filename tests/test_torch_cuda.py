"""The CUDA opacity kernel on the card (marker ``cuda``; skips without a GPU
and nvcc).  Run on the card with ``python -m pytest -m cuda tests/``."""

import numpy as np
import pytest
import torch

from spectrobot_tpu_torch.ops import cuda_opacity as co

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, n_states=6, n_lines=300, n_points=1000, seed=0):
    """Random states with one all-zero state, float32 on ``device``."""
    rng = np.random.default_rng(seed)
    nu0 = np.sort(rng.uniform(-30.0, 30.0, n_lines)).astype(np.float32)
    nu_c = nu0 + rng.uniform(-0.01, 0.002, (n_states, n_lines))
    sx = 10.0 ** rng.uniform(2.5, 3.5, (n_states, 1)) * np.ones(n_lines)
    y = 10.0 ** rng.uniform(-3.0, 1.0, (n_states, n_lines))
    amps = 10.0 ** rng.uniform(-2.0, 2.0, (n_states, 2, n_lines))
    amps[2] = 0.0
    chi = rng.uniform(0.0, 0.3, (n_states, n_lines))
    nu = np.linspace(-25.0, 25.0, n_points)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return t(nu), nu0, t(nu_c), t(sx), t(y), t(amps), t(chi)


@pytest.mark.parametrize("with_chi", [False, True])
@pytest.mark.parametrize("cutoff", [25.0, None])
def test_kernel_matches_plain(cuda, with_chi, cutoff):
    nu, nu0, nc, sx, y, amps, chi = _inputs(cuda)
    chi = chi if with_chi else None
    before = co.LAUNCHES
    got = co.accumulate_batch(nu, nu0, nc, sx, y, amps, cutoff_cm1=cutoff,
                              chi_b=chi)
    torch.cuda.synchronize()
    assert co.LAUNCHES == before + 1
    ref = co.accumulate_batch_plain(nu, nc, sx, y, amps, cutoff_cm1=cutoff,
                                    chi_b=chi)
    assert torch.all(got[2] == 0)
    # The reference's Pallas parity budget (tests/test_pallas_opacity.py).
    torch.testing.assert_close(got, ref, rtol=3e-5,
                               atol=1e-6 * float(ref.abs().max()))


def test_kernel_is_deterministic(cuda):
    args = _inputs(cuda)[:6]
    a = co.accumulate_batch(*args)
    b = co.accumulate_batch(*args)
    assert torch.equal(a, b)


def test_kernel_rejects_what_it_does_not_take(cuda):
    nu, nu0, nc, sx, y, amps, _ = _inputs(cuda)
    with pytest.raises(ValueError, match="cpu"):
        co.accumulate_batch(nu, nu0, nc.cpu(), sx, y, amps)
    with pytest.raises(ValueError, match="ascending"):
        co.accumulate_batch(nu, nu0[::-1].copy(), nc, sx, y, amps)
    with pytest.raises(ValueError, match="ascending"):
        co.accumulate_batch(nu, nu0[:-1], nc, sx, y, amps)
