"""The benchmark's frozen copies of the port's roofline and trace
arithmetic agree with the port's current functions on small inputs."""

import numpy as np
import pytest
import torch

from spectrobench.yardstick import roofline as ours
from spectrobench.yardstick import trace as our_trace


def _case(seed=0, B=5, L=40, P=300):
    g = torch.Generator().manual_seed(seed)
    nu = torch.linspace(-20.0, 20.0, P, dtype=torch.float64)
    nu_c = (torch.rand(B, L, generator=g, dtype=torch.float64) - 0.5) * 50
    sx = 10 ** (torch.rand(B, L, generator=g, dtype=torch.float64) * 4)
    y = torch.rand(B, L, generator=g, dtype=torch.float64) * 3
    live = torch.tensor([True, False, True, True, False])
    return nu, nu_c, sx, y, live


@pytest.mark.parametrize("cutoff", [None, 5.0, 25.0])
def test_region_counts_and_bounds_match_the_port(cutoff):
    from spectrobot_tpu_torch import roofline as port
    case = _case()
    ours_pairs = ours.region_counts(*case, cutoff)
    assert ours_pairs == port.region_counts(*case, cutoff)
    assert sum(ours_pairs.values()) > 0
    for flops in ("REGION_FLOPS", "REGION_FLOPS_GRAD"):
        assert getattr(ours, flops) == getattr(port, flops)
        assert (ours.bound_ms(ours_pairs, getattr(ours, flops), 8.0, 1e6)
                == port.bound_ms(ours_pairs, getattr(port, flops), 8.0,
                                 1e6))
    for R in (2, 64, 300):
        n_bytes = ours.basis_batch_bytes(620, 2048, 8192, R)
        assert n_bytes == port.basis_batch_bytes(620, 2048, 8192, R)
        assert (ours.basis_bound_ms(ours_pairs, R, n_bytes)
                == port.basis_bound_ms(ours_pairs, R, n_bytes))
    assert (ours.FP32_FLOPS, ours.TF32_FLOPS, ours.HBM_BYTES_S) == (
        port.FP32_FLOPS, port.TF32_FLOPS, port.HBM_BYTES_S)


def test_k1_bound_counts_the_port_smoke_bytes():
    pairs = {"I": 10 ** 9, "II": 10 ** 6, "III": 10 ** 5, "IV": 10 ** 4}
    B, L, P = 620, 2048, 8192
    n_bytes = 4.0 * (P + 3 * B * L) + 4.0 * (2 * B * L + 2 * B * P)
    assert ours.k1_bound_ms(pairs, B, L, P) == ours.bound_ms(
        pairs, ours.REGION_FLOPS, 8.0, n_bytes)[0]


def test_busy_and_family_match_the_port():
    from spectrobot_tpu_torch.breakdown import busy_us
    from spectrobot_tpu_torch.trace_summary import family
    g = np.random.default_rng(1)
    iv = [(float(s), float(s + d)) for s, d in zip(g.uniform(0, 100, 50),
                                                   g.uniform(0, 10, 50))]
    assert our_trace.busy_us(iv) == busy_us(iv)
    for name in ("void opacity_batch_kernel<2>(float const*, int)",
                 "void at::native::(anonymous namespace)::elementwise_kernel"
                 "<128, 4, at::native::gpu_kernel_impl<>>(int)",
                 "Memcpy DtoD (Device -> Device)", "ncclDevKernel_AllReduce"):
        assert our_trace.family(name) == family(name)


def test_idle_gaps_and_exposure():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert our_trace.idle_gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    assert our_trace.busy_us(iv) == 4.0
    assert our_trace.exposed_us([(2.5, 4.5)], iv) == 1.5
