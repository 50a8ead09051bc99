"""K2 past its row limit (spectrobot_tpu_torch/ops/cuda_basis.py): the
reference's basis contraction takes any number of coefficient rows, and the
port's kernel route cuts more than ``MAX_ROWS`` into row groups, one launch
a group (``row_spans``, ``contract_row_groups``).  On the CPU the split runs
with the plain version as the callee: the groups cover the rows exactly, as
evenly as the count allows, and give one plain call's result bit for bit
and the reference's Pallas kernel's (interpret mode) within its budget."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.synth import random_lines
from spectrobot_tpu.ops import opacity as jop
from spectrobot_tpu.ops.pallas_opacity import basis_contract_pallas_batch_jit
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu_torch.ops import cuda_basis as cb

torch.set_num_threads(1)

ROWS = (1, 223, 224, 228, 450)


def _case(R, seed=7, L=40, P=96, B=2):
    """B states of L random lines on P points (float32) with R random
    coefficient rows, as numpy."""
    rng = np.random.default_rng(seed)
    dl = j_stage(random_lines(L, 600.0, 640.0, seed=seed), [(2, 1)],
                 dtype=jnp.float32, nu_ref=0.0)
    kl = jop.line_kernel_inputs(dl, 220.0, 500.0, 50.0,
                                amp_weights=jnp.ones((2, L), jnp.float32))
    f32 = lambda a: np.asarray(a, np.float32)
    nc = f32([np.asarray(kl.nu_c) + 0.02 * b for b in range(B)])
    sx = f32([np.asarray(kl.scale_x) * (1 + 0.05 * b) for b in range(B)])
    y = f32([np.asarray(kl.y) * (1 + 0.1 * b) for b in range(B)])
    amps = np.asarray(kl.amps, np.float32)
    C = [f32(rng.normal(size=(B, R, L)) * amps[0]) for _ in range(4)]
    nu = np.linspace(605.0, 635.0, P).astype(np.float32)
    return nu, nc, sx, y, C


@pytest.mark.parametrize("R", ROWS)
def test_row_spans_cover_the_rows_evenly(R):
    spans = cb.row_spans(R)
    assert spans[0][0] == 0 and spans[-1][1] == R
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    sizes = [b - a for a, b in spans]
    assert len(spans) == -(-R // cb.MAX_ROWS)
    assert all(1 <= n <= cb.MAX_ROWS for n in sizes)
    assert max(sizes) - min(sizes) <= 1
    assert {228: [114, 114], 450: [150, 150, 150]}.get(R, sizes) == sizes


@pytest.mark.parametrize("R", ROWS)
def test_row_groups_equal_one_plain_call(R):
    """The split with the plain version as the callee, one call a group
    writing its rows of one output: bit-equal to one plain call over
    every row."""
    nu, nc, sx, y, C = (torch.as_tensor(a) if not isinstance(a, list)
                        else [torch.as_tensor(c) for c in a]
                        for a in _case(R))
    one = cb.basis_contract_batch_plain(nu, nc, sx, y, *C)
    calls = []

    def contract(Cg, out_g):
        calls.append(Cg[0].shape[1])
        out_g.copy_(cb.basis_contract_batch_plain(nu, nc, sx, y, *Cg))

    out = torch.full_like(one, float("nan"))
    got = cb.contract_row_groups(C, out, contract)
    assert got is out
    assert calls == [b - a for a, b in cb.row_spans(R)]
    assert torch.equal(got, one)


def test_row_groups_match_the_reference_at_228_rows():
    """Two groups of 114 rows against the reference's basis kernel in
    interpret mode, which takes the 228 rows in one call (K2's budget,
    tests/test_pallas_jacobian.py:124); the CPU wrapper itself never
    launches."""
    nu, nc, sx, y, C = _case(228, seed=3)
    ref = np.asarray(basis_contract_pallas_batch_jit(
        jnp.asarray(nu), jnp.asarray(nc), jnp.asarray(sx), jnp.asarray(y),
        *(jnp.asarray(c) for c in C), cutoff_cm1=25.0, interpret=True))
    t = torch.as_tensor
    Ct = [t(c) for c in C]
    before = cb.LAUNCHES
    got = cb.contract_row_groups(
        Ct, torch.empty(ref.shape, dtype=torch.float32),
        lambda Cg, out_g: out_g.copy_(cb.basis_contract_batch_plain(
            t(nu), t(nc), t(sx), t(y), *Cg)))
    assert cb.LAUNCHES == before
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-5 * np.abs(ref).max()
