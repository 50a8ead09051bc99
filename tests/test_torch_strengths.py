"""Stage-1 prologue of the PyTorch port (line strengths, widths, shifts ->
kernel inputs) against the JAX reference, in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.ops.opacity import line_kernel_inputs as j_kernel_inputs
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu_torch.interop import device_lines_from_numpy
from spectrobot_tpu_torch.ops.opacity import line_kernel_inputs
from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist


@pytest.fixture(scope="module")
def lines(co2_lines):
    jl = j_stage(co2_lines, [(2, 1)], dtype=jnp.float64)
    tl = device_lines_from_linelist(co2_lines, [(2, 1)], dtype=torch.float64,
                                    device="cpu")
    return jl, tl


def test_staging_matches(lines):
    jl, tl = lines
    for name in jl._fields:
        np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                      np.asarray(getattr(jl, name)), name)


@pytest.mark.parametrize("T,p,p_self", [(150.0, 1.0, 0.9),
                                        (213.7, 310.0, 295.0),
                                        (296.0, 1.0e5, 0.0)])
def test_line_kernel_inputs_f64(lines, T, p, p_self):
    jl, _ = lines
    # Fed through interop, as the forward tests feed every structure.
    tl = device_lines_from_numpy(
        {k: np.asarray(v) for k, v in jl._asdict().items()}, device="cpu")
    w = np.random.default_rng(0).uniform(0.5, 1.5, (2, jl.n_lines))
    ref = j_kernel_inputs(jl, T, p, p_self, amp_weights=jnp.asarray(w))
    got = line_kernel_inputs(tl, T, p, p_self, torch.as_tensor(w))
    for name in ("nu_c", "scale_x", "y", "amps"):
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=0, err_msg=name)


def test_line_kernel_inputs_per_line_batch(lines):
    """Batched per-line states [R, NL, L] equal the per-state calls."""
    _, tl = lines
    rng = np.random.default_rng(1)
    T = torch.as_tensor(rng.uniform(140, 250, (2, 3, 1))).expand(
        2, 3, tl.n_lines)
    p = torch.as_tensor(rng.uniform(1, 600, (2, 3, 1))).expand(
        2, 3, tl.n_lines)
    batch = line_kernel_inputs(tl, T, p, 0.9 * p)
    for r in range(2):
        for l in range(3):
            one = line_kernel_inputs(tl, float(T[r, l, 0]), float(p[r, l, 0]),
                                     0.9 * float(p[r, l, 0]))
            for name in ("nu_c", "scale_x", "y", "amps"):
                torch.testing.assert_close(getattr(batch, name)[r, l],
                                           getattr(one, name), rtol=1e-14,
                                           atol=0)
