"""The CUDA kernels (K1, K2, K5, K3, K4, the remote-copy tier's ring and
fused halo kernels, and the FMA measurement kernel) on the card, and the
CLI's mesh route, the nu-halo exchange's overlap, the mesh bodies' CUDA
graphs against their eager bodies and the remote-copy tier across the
machine's cards (marker ``cuda``; skips without a GPU and nvcc,
the multi-card tests without a second card).  Run on the card with
``python -m pytest -m cuda tests/``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spectrobot_tpu_torch.ops import cuda_basis as cb
from spectrobot_tpu_torch.ops import cuda_opacity as co
from spectrobot_tpu_torch.ops.cuda_single import segments

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
    win = co.line_windows(nu, nu0, cutoff_cm1=cutoff)
    got = co.accumulate_batch(nu, win, nc, sx, y, amps, cutoff_cm1=cutoff,
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
    nu, nu0, *args = _inputs(cuda)[:6]
    args = [nu, co.line_windows(nu, nu0), *args]
    a = co.accumulate_batch(*args)
    b = co.accumulate_batch(*args)
    assert torch.equal(a, b)


def test_kernel_rejects_what_it_does_not_take(cuda):
    nu, nu0, nc, sx, y, amps, _ = _inputs(cuda)
    win = co.line_windows(nu, nu0)
    with pytest.raises(ValueError, match="cpu"):
        co.accumulate_batch(nu, win, nc.cpu(), sx, y, amps)
    with pytest.raises(ValueError, match="ascending"):
        co.line_windows(nu, nu0[::-1].copy())
    with pytest.raises(ValueError, match="lines"):
        co.accumulate_batch(nu, co.line_windows(nu, nu0[:-1]), nc, sx, y,
                            amps)
    with pytest.raises(TypeError, match="Windows"):
        co.accumulate_batch(nu, nu0, nc, sx, y, amps)


def _tensor_ops(call) -> list:
    """The tensor operations one warm ``call`` dispatches, by name (a
    kernel launched through ctypes is not one of them)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    call()
    torch.cuda.synchronize()
    with Record() as rec:
        call()
    return rec.ops


@pytest.mark.parametrize("n_lines,n_points", [(300, 1000), (129, 383),
                                              (31, 130)])
def test_kernel_takes_rows_of_any_length(cuda, n_lines, n_points):
    """K1 on L and P that are not multiples of 128: the wrapper allocates
    the output and launches the kernel once, with no other tensor operation
    (no padded copies, no mask, no slice), and writes [B, 2, P] within
    K1's budget of the plain version."""
    nu, nu0, nc, sx, y, amps, chi = _inputs(cuda, n_lines=n_lines,
                                            n_points=n_points)
    win = co.line_windows(nu, nu0)
    for chi_b in (None, chi):
        call = lambda: co.accumulate_batch(nu, win, nc, sx, y, amps,
                                           chi_b=chi_b)
        before = co.LAUNCHES
        assert _tensor_ops(call) == ["aten.empty.memory_format"]
        assert co.LAUNCHES == before + 2
        got = call()
        ref = co.accumulate_batch_plain(nu, nc, sx, y, amps, chi_b=chi_b)
        assert got.shape == (nc.shape[0], 2, n_points) and got.is_contiguous()
        torch.testing.assert_close(got, ref, rtol=3e-5,
                                   atol=1e-6 * float(ref.abs().max()))


def test_kernel_writes_exact_zeros_beyond_the_cutoff(cuda):
    """One line block whose first sub-block lies left of the grid and whose
    other lines lie right of it, each beyond the cutoff of every point:
    every tile visits the block and writes exact zeros.  A state with
    all-zero amplitudes writes exact zeros too; a third state with lines
    inside the grid does not."""
    rng = np.random.default_rng(11)
    nu = np.linspace(-30.0, 30.0, 700)
    nu0 = np.sort(np.concatenate([rng.uniform(-45.0, -41.0, 32),
                                  rng.uniform(41.0, 45.0, 96)]))
    nc = np.stack([nu0, nu0, np.linspace(-20.0, 20.0, 128)])
    sx = np.full((3, 128), 1e3)
    y = np.full((3, 128), 0.05)
    amps = rng.uniform(0.5, 2.0, (3, 2, 128))
    amps[1] = 0.0
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    win = co.line_windows(t(nu), nu0.astype(np.float32), cutoff_cm1=10.0)
    assert int(win.counts.min()) == 1          # every tile visits the block
    got = co.accumulate_batch(t(nu), win, t(nc), t(sx), t(y), t(amps),
                              cutoff_cm1=10.0)
    torch.cuda.synchronize()
    assert torch.all(got[:2] == 0)
    assert float(got[2].abs().min()) > 0


# ---------------------------------------------------------------------------
# K2: the basis contraction (csrc/basis_batch.cu)
# ---------------------------------------------------------------------------


def _basis_inputs(device, n_rows=10, seed=1, **kw):
    """K1's random states plus random coefficient rows scaled by the
    amplitudes (so the dead state stays dead and C2, the Kx row, is
    exercised, which a temperature-only Jacobian never fills)."""
    nu, nu0, nc, sx, y, amps, chi = _inputs(device, seed=seed, **kw)
    rng = np.random.default_rng(seed + 100)
    scale = amps[:, :1].cpu().numpy()
    C = [torch.as_tensor(
        (rng.normal(size=(nc.shape[0], n_rows, nc.shape[1])) * scale)
        .astype(np.float32), device=device) for _ in range(4)]
    return nu, nu0, nc, sx, y, C, chi


# Row counts of the tensor-core contraction: one n-tile (1, 2), the
# narrowest accumulator (10), the slice's 66 and 68 (not multiples of 8
# over three n-tile chunks), and the widest accumulator at K2's largest R.
BASIS_ROWS = [1, 2, 10, 66, 68, 223]


@pytest.mark.parametrize("n_rows", BASIS_ROWS)
@pytest.mark.parametrize("with_chi", [False, True])
@pytest.mark.parametrize("cutoff", [25.0, None])
def test_basis_kernel_matches_plain(cuda, n_rows, with_chi, cutoff):
    nu, nu0, nc, sx, y, C, chi = _basis_inputs(cuda, n_rows=n_rows)
    chi = chi if with_chi else None
    before = cb.LAUNCHES
    win = co.line_windows(nu, nu0, cutoff_cm1=cutoff)
    got = cb.basis_contract_batch(nu, win, nc, sx, y, *C, cutoff_cm1=cutoff,
                                  chi_b=chi)
    torch.cuda.synchronize()
    assert cb.LAUNCHES == before + 1
    ref = cb.basis_contract_batch_plain(nu, nc, sx, y, *C, cutoff_cm1=cutoff,
                                        chi_b=chi)
    assert got.shape == ref.shape == (nc.shape[0], n_rows, nu.shape[0])
    assert torch.all(got[2] == 0)            # the dead state
    # The reference's basis-kernel parity (tests/test_pallas_jacobian.py).
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_basis_kernel_takes_the_scene_windows(cuda):
    nu, nu0, nc, sx, y, C, _ = _basis_inputs(cuda)
    a = cb.basis_contract_batch(nu, co.line_windows(nu, nu0), nc, sx, y, *C)
    b = cb.basis_contract_batch(nu, co.line_windows(nu, nu0), nc, sx, y, *C)
    assert torch.equal(a, b)
    with pytest.raises(TypeError, match="Windows"):
        cb.basis_contract_batch(nu, nu0, nc, sx, y, *C)
    with pytest.raises(ValueError, match="cutoff"):
        cb.basis_contract_batch(nu, co.line_windows(nu, nu0, cutoff_cm1=None),
                                nc, sx, y, *C)
    with pytest.raises(ValueError, match="windows are on"):
        cb.basis_contract_batch(nu, co.line_windows(nu.cpu(), nu0), nc, sx,
                                y, *C)


@pytest.mark.parametrize("n_rows", [10, 66, 223])
def test_basis_kernel_is_deterministic(cuda, n_rows):
    nu, nu0, nc, sx, y, C, chi = _basis_inputs(cuda, n_rows=n_rows)
    win = co.line_windows(nu, nu0)
    a = cb.basis_contract_batch(nu, win, nc, sx, y, *C, chi_b=chi)
    b = cb.basis_contract_batch(nu, win, nc, sx, y, *C, chi_b=chi)
    assert torch.equal(a, b)


def test_basis_kernel_rejects_what_it_does_not_take(cuda):
    nu, nu0, nc, sx, y, C, _ = _basis_inputs(cuda)
    win = co.line_windows(nu, nu0)
    with pytest.raises(ValueError, match="cpu"):
        cb.basis_contract_batch(nu, win, nc, sx.cpu(), y, *C)
    with pytest.raises(TypeError, match="float32"):
        cb.basis_contract_batch(nu, win, nc, sx, y, C[0].double(), *C[1:])
    # One row past a launch's limit: two launches (112 + 112 rows), each
    # row the same as at the limit in one launch.
    for R, n in ((cb.MAX_ROWS, 1), (cb.MAX_ROWS + 1, 2)):
        before = cb.LAUNCHES
        rows = [c[:, :1].expand(-1, R, -1).contiguous() for c in C]
        out = cb.basis_contract_batch(nu, win, nc, sx, y, *rows)
        torch.cuda.synchronize()
        assert cb.LAUNCHES == before + n and out.shape[1] == R
        assert torch.equal(out[:, 0], out[:, -1])


@pytest.mark.parametrize("n_rows", [228, 450])
def test_basis_kernel_takes_any_number_of_rows(cuda, n_rows):
    """Past MAX_ROWS the wrapper launches once a row group (two of 114,
    three of 150), each writing its rows of one output: against the
    plain version within K2's budget."""
    nu, nu0, nc, sx, y, C, chi = _basis_inputs(cuda, n_rows=n_rows)
    before = cb.LAUNCHES
    got = cb.basis_contract_batch(nu, co.line_windows(nu, nu0), nc, sx, y,
                                  *C, chi_b=chi)
    torch.cuda.synchronize()
    assert cb.LAUNCHES == before + len(cb.row_spans(n_rows))
    ref = cb.basis_contract_batch_plain(nu, nc, sx, y, *C, chi_b=chi)
    assert got.shape == ref.shape == (nc.shape[0], n_rows, nu.shape[0])
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_basis_kernels_take_rows_off_a_16_byte_boundary(cuda):
    """The kernels copy coefficient rows 16 bytes at a time: rows that
    start one float into their storage (L a multiple of 128, so no padding
    copy) are copied by the wrappers and give the aligned rows' result."""
    from spectrobot_tpu_torch.ops import cuda_basis_single as cbs
    nu, nu0, nc, sx, y, C, _ = _basis_inputs(cuda, n_lines=256)
    win = co.line_windows(nu, nu0)
    off = [torch.empty(c.numel() + 1, device=cuda)[1:].view_as(c).copy_(c)
           for c in C]
    assert all(c.data_ptr() % 16 != 0 and c.is_contiguous() for c in off)
    assert torch.equal(cb.basis_contract_batch(nu, win, nc, sx, y, *off),
                       cb.basis_contract_batch(nu, win, nc, sx, y, *C))
    one = [c[3] for c in off]
    assert torch.equal(
        cbs.basis_contract_single(nu, win, nc[3], sx[3], y[3], *one),
        cbs.basis_contract_single(nu, win, nc[3], sx[3], y[3],
                                  *(c[3] for c in C)))


def test_jacobian_through_the_kernels_matches_plain(cuda):
    """torch.func.jacfwd of a small limb forward on the card: one K1 and one
    K2 launch, and the plain engine's Jacobian within 1e-5 max|J|."""
    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch.retrieval.state import flatten_state, make_state

    cfg = cli.load_config(None, {
        "grid.nu_min": "660.0", "grid.nu_max": "674.0",
        "grid.n_points": "512", "scene.n_levels": "9",
        "geometry.tangent_heights_km": "8.0,25.0,40.0",
        "geometry.n_sub": "2", "instrument.enabled": "true",
        "instrument.n_channels": "32", "compute.dtype": "float32"})
    scene = cli.build_scene(cfg, cuda)
    atm = scene.atm.to(torch.float32)       # as cmd_retrieve casts it
    x0, unravel = flatten_state(make_state(atm, []))
    jac = {}
    for engine in (cb.KERNELS, cb.PLAIN):
        fwd = cli.scene_forward(cfg, scene, atm, engine)
        k1, k2 = co.LAUNCHES, cb.LAUNCHES
        jac[engine.name] = torch.func.jacfwd(lambda x: fwd(unravel(x)))(x0)
        torch.cuda.synchronize()
        launched = (co.LAUNCHES - k1, cb.LAUNCHES - k2)
        assert launched == ((1, 1) if engine is cb.KERNELS else (0, 0))
    J, J_plain = jac["kernels"], jac["plain"]
    assert J.shape == (3 * 32, 9) and bool(torch.isfinite(J).all())
    assert float((J - J_plain).abs().max()) <= 1e-5 * float(
        J_plain.abs().max())


# ---------------------------------------------------------------------------
# K5: the transposed basis contraction (csrc/basis_transpose.cu)
# ---------------------------------------------------------------------------


def _transpose_inputs(device, n_rows, seed=2):
    """K1's random states with random cotangent rows; state 2 has zero
    amplitudes but live rows (its amplitude cotangent is not zero) and
    state 4 has all-zero rows (dead for K5)."""
    nu, nu0, nc, sx, y, amps, chi = _inputs(device, seed=seed)
    rng = np.random.default_rng(seed + 200)
    ct = rng.normal(size=(nc.shape[0], n_rows, nu.shape[0]))
    ct[4] = 0.0
    ct = torch.as_tensor(ct.astype(np.float32), device=device)
    return nu, nu0, nc, sx, y, amps, chi, ct


@pytest.mark.parametrize("n_rows", [2, 10])
@pytest.mark.parametrize("with_chi", [False, True])
@pytest.mark.parametrize("cutoff", [25.0, None])
def test_transpose_kernel_matches_plain(cuda, n_rows, with_chi, cutoff):
    from spectrobot_tpu_torch.ops import cuda_transpose as ctr

    nu, nu0, nc, sx, y, _, chi, ct = _transpose_inputs(cuda, n_rows)
    chi = chi if with_chi else None
    before = ctr.LAUNCHES
    win = co.line_windows(nu, nu0, cutoff_cm1=cutoff)
    got = ctr.basis_transpose_batch(nu, win, nc, sx, y, ct,
                                    cutoff_cm1=cutoff, chi_b=chi)
    torch.cuda.synchronize()
    assert ctr.LAUNCHES == before + 1
    ref = ctr.basis_transpose_batch_plain(nu, nc, sx, y, ct,
                                          cutoff_cm1=cutoff, chi_b=chi)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (nc.shape[0], n_rows, nc.shape[1])
        assert torch.all(g[4] == 0)              # all-zero rows: dead
        assert float(g[2].abs().max()) > 0       # zero amps: still live
        # K2's budget (tests/test_pallas_jacobian.py:124).
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())
    again = ctr.basis_transpose_batch(nu, win, nc, sx, y, ct,
                                      cutoff_cm1=cutoff, chi_b=chi)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("target", [1, 1 << 20])
@pytest.mark.parametrize("with_chi", [False, True])
def test_transpose_kernel_over_segments(cuda, monkeypatch, target, with_chi):
    """K5 with each window in one segment (a block target of 1) and cut
    into a segment per tile (a target above the tiles of every window):
    both within 1e-5 max|ref| of the plain version, each bit-equal from
    call to call; the wrapper allocates the outputs (and the workspace of
    the segments' partial sums) and launches the kernel once, with no other
    tensor operation."""
    from spectrobot_tpu_torch.ops import cuda_transpose as ctr

    monkeypatch.setattr(ctr, "TARGET_BLOCKS", target)
    nu, nu0, nc, sx, y, _, chi, ct = _transpose_inputs(cuda, 2)
    chi = chi if with_chi else None
    win = co.line_windows(nu, nu0)
    n_seg, seg_tiles = ctr.segments(win, nc.shape[0])
    assert (n_seg == 1) == (target == 1) and (target == 1 or seg_tiles == 1)
    call = lambda: ctr.basis_transpose_batch(nu, win, nc, sx, y, ct,
                                             chi_b=chi)
    before = ctr.LAUNCHES
    ops = _tensor_ops(call)
    assert ops == ["aten.empty.memory_format"] * (4 if n_seg == 1 else 5)
    assert ctr.LAUNCHES == before + 2
    got = call()
    ref = ctr.basis_transpose_batch_plain(nu, nc, sx, y, ct, chi_b=chi)
    for g, r in zip(got, ref):
        assert torch.all(g[4] == 0)              # all-zero rows
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(got, call()))


def test_transpose_kernel_on_the_dense_shape(cuda):
    """K5 at B = 1 on the reference bench's dense shape (20480 random lines
    over 600-740 cm-1, 16384 points, no cutoff; many segments) against the
    plain version, within 1e-5 max|ref| of each output."""
    from spectrobot_tpu_torch.data.lines import random_lines
    from spectrobot_tpu_torch.ops import cuda_transpose as ctr
    from spectrobot_tpu_torch.ops.opacity import line_kernel_inputs
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist

    dl = device_lines_from_linelist(random_lines(20480, 600.0, 740.0, seed=0),
                                    [(2, 1)], dtype=torch.float32,
                                    device=cuda, nu_ref=0.0)
    kl = line_kernel_inputs(dl, 220.0, 300.0, 100.0,
                            amp_weights=torch.ones(2, dl.n_lines, device=cuda))
    nu = torch.as_tensor(np.linspace(640.0, 700.0, 16384),
                         dtype=torch.float32, device=cuda)
    win = co.line_windows(nu, dl.nu0, cutoff_cm1=None)
    assert ctr.segments(win, 1)[0] > 1
    nc, sx, y = (a[None].contiguous() for a in kl[:3])
    ct = torch.as_tensor(np.random.default_rng(12).normal(
        size=(1, 2, nu.shape[0])).astype(np.float32), device=cuda)
    got = ctr.basis_transpose_batch(nu, win, nc, sx, y, ct, cutoff_cm1=None)
    ref = ctr.basis_transpose_batch_plain(nu, nc, sx, y, ct, cutoff_cm1=None)
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())


def test_transpose_kernel_rejects_what_it_does_not_take(cuda):
    from spectrobot_tpu_torch.ops import cuda_transpose as ctr

    nu, nu0, nc, sx, y, _, _, ct = _transpose_inputs(cuda, 2)
    win = co.line_windows(nu, nu0)
    with pytest.raises(ValueError, match="cpu"):
        ctr.basis_transpose_batch(nu, win, nc, sx, y, ct.cpu())
    with pytest.raises(TypeError, match="float32"):
        ctr.basis_transpose_batch(nu, win, nc, sx, y, ct.double())
    big = ct[:, :1].expand(-1, ctr.MAX_ROWS + 1, -1).contiguous()
    with pytest.raises(ValueError, match="rows"):
        ctr.basis_transpose_batch(nu, win, nc, sx, y, big)
    with pytest.raises(TypeError, match="Windows"):
        ctr.basis_transpose_batch(nu, nu0, nc, sx, y, ct)
    rows = ct[:, :1].expand(-1, ctr.MAX_ROWS, -1).contiguous()
    out = ctr.basis_transpose_batch(nu, win, nc, sx, y, rows)
    torch.cuda.synchronize()
    assert torch.equal(out[0][:, 0], out[0][:, -1])


def test_transpose_is_the_adjoint_of_the_contraction(cuda):
    """<ct, K2(C)> = sum_k <C_k, K5(ct)_k> on the card, to float32
    roundoff: within 1e-5 of the larger sum of absolute products."""
    from spectrobot_tpu_torch.ops import cuda_transpose as ctr

    nu, nu0, nc, sx, y, C, chi = _basis_inputs(cuda, n_rows=6)
    ct = torch.as_tensor(np.random.default_rng(9).normal(
        size=(nc.shape[0], 6, nu.shape[0])).astype(np.float32), device=cuda)
    win = co.line_windows(nu, nu0)
    out = cb.basis_contract_batch(nu, win, nc, sx, y, *C, chi_b=chi)
    Ab = ctr.basis_transpose_batch(nu, win, nc, sx, y, ct, chi_b=chi)
    d = lambda a: a.double()
    lhs = float(torch.sum(d(ct) * d(out)))
    rhs = sum(float(torch.sum(d(c) * d(a))) for c, a in zip(C, Ab))
    scale = max(float(torch.sum((d(ct) * d(out)).abs())),
                sum(float(torch.sum((d(c) * d(a)).abs()))
                    for c, a in zip(C, Ab)))
    assert abs(lhs - rhs) <= 1e-5 * scale


def test_jacrev_through_the_kernels_matches_jacfwd(cuda):
    """torch.func.jacrev of a small limb forward in reverse mode on the
    card: one K1 and one K5 launch (32 outputs x 2 depths fold into one
    call), and the kernels' jacfwd Jacobian within 1e-5 max|J|."""
    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch.ops import cuda_transpose as ctr
    from spectrobot_tpu_torch.retrieval.state import (
        build_forward, flatten_state, make_state)

    cfg = cli.load_config(None, {
        "grid.nu_min": "660.0", "grid.nu_max": "674.0",
        "grid.n_points": "512", "scene.n_levels": "9",
        "geometry.tangent_heights_km": "8.0,30.0", "geometry.n_sub": "2",
        "instrument.enabled": "true", "instrument.n_channels": "16",
        "compute.dtype": "float32"})
    scene = cli.build_scene(cfg, cuda)
    atm = scene.atm.to(torch.float32)
    x0, unravel = flatten_state(make_state(atm, []))
    fwd = {mode: build_forward(
        atm, scene.lines, scene.nu, scene.species_names, scene.planet,
        tangent_heights_m=torch.tensor([8e3, 30e3], device=cuda),
        ils_W=scene.W, n_sub=2, nu_off=scene.nu_off, windows=scene.windows,
        analytic_jvp=mode) for mode in (True, "rev")}
    J = torch.func.jacfwd(lambda x: fwd[True](unravel(x)))(x0)
    k1, k5 = co.LAUNCHES, ctr.LAUNCHES
    Jr = torch.func.jacrev(lambda x: fwd["rev"](unravel(x)))(x0)
    torch.cuda.synchronize()
    assert (co.LAUNCHES - k1, ctr.LAUNCHES - k5) == (1, 1)
    assert Jr.shape == J.shape == (2 * 16, 9)
    assert float((Jr - J).abs().max()) <= 1e-5 * float(J.abs().max())


# ---------------------------------------------------------------------------
# K3: the single-state line sum (csrc/opacity_single.cu)
# ---------------------------------------------------------------------------


def _single_inputs(device, n_out, n_lines=2000, n_points=3000, seed=3):
    """One state drawn as K1's random states are, with ``n_out`` random
    amplitude rows; 2000 lines over 60 cm-1 give windows of many line
    blocks, so K3 cuts them into several segments."""
    rng = np.random.default_rng(seed)
    nu0 = np.sort(rng.uniform(-30.0, 30.0, n_lines)).astype(np.float32)
    nu_c = nu0 + rng.uniform(-0.01, 0.002, n_lines)
    sx = np.full(n_lines, 10.0 ** rng.uniform(2.5, 3.5))
    y = 10.0 ** rng.uniform(-3.0, 1.0, n_lines)
    amps = 10.0 ** rng.uniform(-2.0, 2.0, (n_out, n_lines))
    chi = rng.uniform(0.0, 0.3, n_lines)
    nu = np.linspace(-25.0, 25.0, n_points)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return t(nu), nu0, t(nu_c), t(sx), t(y), t(amps), t(chi)


@pytest.mark.parametrize("n_out", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("cutoff", [25.0, None])
def test_single_kernel_matches_plain(cuda, n_out, cutoff):
    from spectrobot_tpu_torch.ops import cuda_single as cs
    nu, nu0, nc, sx, y, amps, chi = _single_inputs(cuda, n_out)
    for chi_b in (None, chi):
        before = cs.LAUNCHES
        win = co.line_windows(nu, nu0, cutoff_cm1=cutoff)
        got = cs.accumulate_single(nu, win, nc, sx, y, amps,
                                   cutoff_cm1=cutoff, chi_b=chi_b)
        torch.cuda.synchronize()
        assert cs.LAUNCHES == before + 1
        assert cs.segments(win)[0] > 1
        ref = cs.accumulate_single_plain(nu, nc, sx, y, amps,
                                         cutoff_cm1=cutoff, chi_b=chi_b)
        assert got.shape == ref.shape == (n_out, nu.shape[0])
        # K1's budget (the reference's Pallas parity budget).
        torch.testing.assert_close(got, ref, rtol=3e-5,
                                   atol=1e-6 * float(ref.abs().max()))


@pytest.mark.parametrize("n_out", [1, 3, 8])
@pytest.mark.parametrize("cutoff", [25.0, None])
def test_single_kernel_takes_rows_of_any_length(cuda, n_out, cutoff):
    """K3 on L and P that are not multiples of 128 (BLOCK_L, TILE_P), with
    chi and without: the wrapper allocates the output and the segments'
    partial sums and launches the kernel once, with no other tensor
    operation (no padded copies, no slice), and writes [n_out, P] within
    K1's budget of the plain version."""
    from spectrobot_tpu_torch.ops import cuda_single as cs
    nu, nu0, nc, sx, y, amps, chi = _single_inputs(cuda, n_out, n_lines=1001,
                                                   n_points=2999)
    win = co.line_windows(nu, nu0, cutoff_cm1=cutoff)
    assert cs.segments(win)[0] > 1
    for chi_b in (None, chi):
        call = lambda: cs.accumulate_single(nu, win, nc, sx, y, amps,
                                            cutoff_cm1=cutoff, chi_b=chi_b)
        before = cs.LAUNCHES
        assert _tensor_ops(call) == ["aten.empty.memory_format"] * 2
        assert cs.LAUNCHES == before + 2
        got = call()
        ref = cs.accumulate_single_plain(nu, nc, sx, y, amps,
                                         cutoff_cm1=cutoff, chi_b=chi_b)
        assert got.shape == (n_out, 2999) and got.is_contiguous()
        torch.testing.assert_close(got, ref, rtol=3e-5,
                                   atol=1e-6 * float(ref.abs().max()))


def test_single_kernel_is_k1_pair_for_pair(cuda):
    """With one segment (a window of one line block) K3 sums every pair in
    K1's order through K1's per-pair code: equal to K1 at B = 1, bit for
    bit."""
    from spectrobot_tpu_torch.ops import cuda_single as cs
    nu, nu0, nc, sx, y, amps, chi = _single_inputs(cuda, 2, n_lines=100,
                                                   n_points=1000)
    win = co.line_windows(nu, nu0)
    assert cs.segments(win) == (1, 1)
    for chi_b in (None, chi):
        k3 = cs.accumulate_single(nu, win, nc, sx, y, amps, chi_b=chi_b)
        k1 = co.accumulate_batch(nu, win, nc[None], sx[None], y[None],
                                 amps[None], chi_b=None if chi_b is None
                                 else chi_b[None])
        assert torch.equal(k3, k1[0])


def test_single_kernel_is_deterministic(cuda):
    from spectrobot_tpu_torch.ops import cuda_single as cs
    nu, nu0, nc, sx, y, amps, _ = _single_inputs(cuda, 3)
    win = co.line_windows(nu, nu0, cutoff_cm1=None)
    a = cs.accumulate_single(nu, win, nc, sx, y, amps, cutoff_cm1=None)
    b = cs.accumulate_single(nu, win, nc, sx, y, amps, cutoff_cm1=None)
    assert torch.equal(a, b)


def test_single_kernel_rejects_what_it_does_not_take(cuda):
    from spectrobot_tpu_torch.ops import cuda_single as cs
    nu, nu0, nc, sx, y, amps, _ = _single_inputs(cuda, 9)
    win = co.line_windows(nu, nu0)
    with pytest.raises(ValueError, match="1 to 8 amplitude rows"):
        cs.accumulate_single(nu, win, nc, sx, y, amps)
    with pytest.raises(TypeError, match="float32"):
        cs.accumulate_single(nu.double(), win, nc.double(), sx.double(),
                             y.double(), amps[:2].double())
    with pytest.raises(ValueError, match="lines"):
        cs.accumulate_single(nu, co.line_windows(nu, nu0[:-1]), nc, sx, y,
                             amps[:2])


# ---------------------------------------------------------------------------
# K4: the single-state basis contraction (csrc/basis_single.cu)
# ---------------------------------------------------------------------------


def _single_basis_inputs(device, n_rows, seed=5, **kw):
    """One state of ``_single_inputs`` with ``n_rows`` random coefficient
    rows scaled by its first amplitude row (C2, the Kx row, included)."""
    nu, nu0, nc, sx, y, amps, chi = _single_inputs(device, 1, seed=seed,
                                                   **kw)
    rng = np.random.default_rng(seed + 100)
    scale = amps[:1].cpu().numpy()
    C = [torch.as_tensor((rng.normal(size=(n_rows, nc.shape[0])) * scale)
                         .astype(np.float32), device=device)
         for _ in range(4)]
    return nu, nu0, nc, sx, y, C, chi


@pytest.mark.parametrize("n_rows", sorted(BASIS_ROWS + [6, 300]))
@pytest.mark.parametrize("cutoff", [25.0, None])
def test_single_basis_kernel_matches_plain(cuda, n_rows, cutoff):
    """K4 against its plain version, with and without chi, over several
    segments; 300 rows take two row groups."""
    from spectrobot_tpu_torch.ops import cuda_basis_single as cbs
    nu, nu0, nc, sx, y, C, chi = _single_basis_inputs(cuda, n_rows)
    win = co.line_windows(nu, nu0, cutoff_cm1=cutoff)
    assert segments(win)[0] > 1
    assert cbs.row_groups(n_rows)[0] == (2 if n_rows > cbs.MAX_ROWS else 1)
    for chi_b in (None, chi):
        before = cbs.LAUNCHES
        got = cbs.basis_contract_single(nu, win, nc, sx, y, *C,
                                        cutoff_cm1=cutoff, chi_b=chi_b)
        torch.cuda.synchronize()
        assert cbs.LAUNCHES == before + 1
        ref = cbs.basis_contract_single_plain(nu, nc, sx, y, *C,
                                              cutoff_cm1=cutoff, chi_b=chi_b)
        assert got.shape == ref.shape == (n_rows, nu.shape[0])
        # The reference's basis-kernel parity (tests/test_pallas_jacobian.py).
        assert float((got - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())


@pytest.mark.parametrize("n_rows", [10, 66, 223])
def test_single_basis_kernel_is_k2_pair_for_pair(cuda, n_rows):
    """With one segment (a window of one line block) and one row group K4
    runs K2's block on the one state: equal to K2 at B = 1, bit for bit, at
    each accumulator width."""
    from spectrobot_tpu_torch.ops import cuda_basis_single as cbs
    nu, nu0, nc, sx, y, C, chi = _single_basis_inputs(
        cuda, n_rows, n_lines=100, n_points=1000)
    win = co.line_windows(nu, nu0)
    assert segments(win) == (1, 1)
    for chi_b in (None, chi):
        k4 = cbs.basis_contract_single(nu, win, nc, sx, y, *C, chi_b=chi_b)
        k2 = cb.basis_contract_batch(nu, win, nc[None], sx[None], y[None],
                                     *(c[None] for c in C),
                                     chi_b=None if chi_b is None
                                     else chi_b[None])
        assert torch.equal(k4, k2[0])


@pytest.mark.parametrize("n_rows", [12, 68])
def test_single_basis_kernel_is_deterministic(cuda, n_rows):
    from spectrobot_tpu_torch.ops import cuda_basis_single as cbs
    nu, nu0, nc, sx, y, C, chi = _single_basis_inputs(cuda, n_rows)
    win = co.line_windows(nu, nu0, cutoff_cm1=None)
    a = cbs.basis_contract_single(nu, win, nc, sx, y, *C, cutoff_cm1=None,
                                  chi_b=chi)
    b = cbs.basis_contract_single(nu, win, nc, sx, y, *C, cutoff_cm1=None,
                                  chi_b=chi)
    assert torch.equal(a, b)


def test_single_basis_kernel_rejects_what_it_does_not_take(cuda):
    from spectrobot_tpu_torch.ops import cuda_basis_single as cbs
    nu, nu0, nc, sx, y, C, _ = _single_basis_inputs(cuda, 4)
    win = co.line_windows(nu, nu0)
    with pytest.raises(ValueError, match="cpu"):
        cbs.basis_contract_single(nu, win, nc, sx.cpu(), y, *C)
    with pytest.raises(TypeError, match="float32"):
        cbs.basis_contract_single(nu, win, nc, sx, y, C[0].double(), *C[1:])
    with pytest.raises(ValueError, match="one state"):
        cbs.basis_contract_single(nu, win, nc[None], sx, y, *C)
    with pytest.raises(ValueError, match="at least one row"):
        cbs.basis_contract_single(nu, win, nc, sx, y, *(c[:0] for c in C))
    with pytest.raises(ValueError, match="lines"):
        cbs.basis_contract_single(nu, co.line_windows(nu, nu0[:-1]), nc, sx,
                                  y, *C)
    with pytest.raises(ValueError, match="cutoff"):
        cbs.basis_contract_single(nu, win, nc, sx, y, *C, cutoff_cm1=None)


# ---------------------------------------------------------------------------
# The engine rule's other humlicek4 configurations: float64 through the
# float32 kernels, and compute.use_pallas = false (the plain engine)
# ---------------------------------------------------------------------------

# The kernels' float32 budgets: sums RTOL |ref| + ATOL_REL max|ref|,
# Jacobians and gradients DERIV_REL max|ref|.
RTOL, ATOL_REL, DERIV_REL = 3e-5, 1e-6, 1e-5
SMALL_SLICE = {"grid.nu_min": "660.0", "grid.nu_max": "674.0",
               "grid.n_points": "512", "scene.n_levels": "9",
               "geometry.tangent_heights_km": "8.0,25.0,40.0",
               "geometry.n_sub": "2", "instrument.enabled": "true",
               "instrument.n_channels": "32"}


def _launched(fn):
    """(fn(), the launches of K1, K2, K5, K3 and K4 it made)."""
    from spectrobot_tpu_torch.ops import cuda_basis_single as cbs
    from spectrobot_tpu_torch.ops import cuda_single as cs
    from spectrobot_tpu_torch.ops import cuda_transpose as ctr
    mods = (co, cb, ctr, cs, cbs)
    before = [m.LAUNCHES for m in mods]
    out = fn()
    torch.cuda.synchronize()
    return out, dict(zip(("K1", "K2", "K5", "K3", "K4"),
                         (m.LAUNCHES - b for m, b in zip(mods, before))))


def test_float64_slice_through_the_kernels(cuda):
    """A small limb slice in float64 through ``KERNELS``: the forward (one
    K1), the jacfwd Jacobian (one K1, one K2) and the reverse gradient of a
    cost (one K1, one K5) are float64 and agree with the same engine over
    the plain versions in float32 (the cast the kernels make) within the
    float32 budgets."""
    import dataclasses

    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch.ops.opacity import with_compute_dtype
    from spectrobot_tpu_torch.retrieval.state import flatten_state, make_state

    cfg = cli.load_config(None, {**SMALL_SLICE, "compute.dtype": "float64"})
    assert cli.select_engine(cfg, cuda) is cb.KERNELS
    cast_plain = with_compute_dtype(
        dataclasses.replace(cb.PLAIN, name="cast"), torch.float32)
    scene = cli.build_scene(cfg, cuda)
    atm = scene.atm.to(torch.float64)
    x0, unravel = flatten_state(make_state(atm, []))
    w = torch.linspace(-1.0, 1.0, 3 * 32, dtype=torch.float64, device=cuda)
    out, n = {}, {}
    for engine in (cb.KERNELS, cast_plain):
        fwd = cli.scene_forward(cfg, scene, atm, engine)
        rev = cli.scene_forward(cfg, scene, atm, engine, "rev")
        f = lambda x: fwd(unravel(x))

        def grad():
            x = x0.clone().requires_grad_()
            return torch.autograd.grad(torch.sum(w * rev(unravel(x))), x)[0]

        out[engine.name, "I"], n[engine.name, "I"] = _launched(lambda: f(x0))
        out[engine.name, "J"], n[engine.name, "J"] = _launched(
            lambda: torch.func.jacfwd(f)(x0))
        out[engine.name, "g"], n[engine.name, "g"] = _launched(grad)
    zero = dict(K1=0, K2=0, K5=0, K3=0, K4=0)
    assert n["kernels", "I"] == {**zero, "K1": 1}
    assert n["kernels", "J"] == {**zero, "K1": 1, "K2": 1}
    assert n["kernels", "g"] == {**zero, "K1": 1, "K5": 1}
    assert all(n["cast", k] == zero for k in "IJg")
    for k in "IJg":
        got, ref = out["kernels", k], out["cast", k]
        assert got.dtype == ref.dtype == torch.float64, k
        assert bool(torch.isfinite(got).all()), k
        scale = float(ref.abs().max())
        if k == "I":
            assert bool(torch.all((got - ref).abs() <= RTOL * ref.abs()
                                  + ATOL_REL * scale))
        else:
            assert float((got - ref).abs().max()) <= DERIV_REL * scale, k


def test_use_pallas_false_runs_the_plain_engine_on_the_card(cuda):
    """``compute.use_pallas = false`` on the card takes ``PLAIN``: a float32
    forward that launches none of the kernels, within K1's budget of the
    kernels' forward."""
    from spectrobot_tpu_torch import cli

    cfg = cli.load_config(None, {**SMALL_SLICE, "compute.use_pallas": "false"})
    engine = cli.select_engine(cfg, cuda)
    assert engine is cb.PLAIN
    scene = cli.build_scene(cfg, cuda)
    I, n = _launched(lambda: cli.run_forward(cfg, scene, engine))
    assert n == dict(K1=0, K2=0, K5=0, K3=0, K4=0)
    I_k, n_k = _launched(lambda: cli.run_forward(cfg, scene, cb.KERNELS))
    assert n_k["K1"] == 1
    assert scene.nu.dtype == torch.float32 and I.dtype == I_k.dtype
    assert bool(torch.all((I - I_k).abs() <= RTOL * I_k.abs()
                          + ATOL_REL * float(I_k.abs().max())))


def test_config1_float64_through_the_kernels(cuda):
    """Acceptance config 1 in float64 through ``KERNELS``: the radiance
    (one K3) float64 within the float32 budget of the float64 oracle
    (tests/test_config1_golden.py:57), its jacfwd over the five scalars
    (one K3, one K4) float64 and finite."""
    from golden import numpy_ref
    from spectrobot_tpu_torch.data import tips
    from spectrobot_tpu_torch.data.synth import co2_15um_band
    from spectrobot_tpu_torch.forward.model import nadir_single_layer
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist

    ll = co2_15um_band(j_max=30)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=torch.float64,
                                    device=cuda)
    nu_host = np.linspace(630.0, 705.0, 3001)
    nu = torch.as_tensor(nu_host, device=cuda)
    sc = dict(T=215.0, p=500.0, col=2.0e27, vmr=0.95, Ts=260.0)
    x = [torch.tensor(v, dtype=torch.float64, device=cuda)
         for v in sc.values()]
    rad = lambda *a: nadir_single_layer(nu, dl, *a)
    I, n = _launched(lambda: rad(*x))
    assert n == dict(K1=0, K2=0, K5=0, K3=1, K4=0)
    q = np.full(len(ll), tips.q_of_T(2, 1, 296.0) / tips.q_of_T(2, 1, 215.0))
    golden = numpy_ref.nadir_single_layer(nu_host, ll, 215.0, 500.0, 2.0e27,
                                          0.95, 260.0, q, cutoff=25.0)
    assert I.dtype == torch.float64
    np.testing.assert_allclose(I.cpu().numpy(), golden, rtol=5e-3,
                               atol=golden.max() * 1e-4)
    J, n = _launched(lambda: torch.func.jacfwd(
        rad, argnums=tuple(range(5)))(*x))
    assert n == dict(K1=0, K2=0, K5=0, K3=1, K4=1)
    assert all(j.dtype == torch.float64 and bool(torch.isfinite(j).all())
               for j in J)


# ---------------------------------------------------------------------------
# The mesh across cards (torchrun, NCCL, one card per rank)
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "examples", "mars_limb.toml")


def test_cli_mesh_on_every_card(cuda, tmp_path):
    """``torchrun --nproc_per_node=n`` of the CLI on the machine's n cards
    against the single-card CLI, float32, examples/mars_limb.toml at a 10
    cm-1 cutoff (the nu-halo tier needs cutoff <= 55 cm-1 / n): the forward
    on the (1, 1, n) mesh in the nu-halo tier, the retrieve on (2, 1, n/2)
    (or (1, 1, n)) in the psum tier.  Tolerances: the kernel-vs-plain
    radiance budget of chip_smoke.py for the radiances; 1e-4 relative for
    the retrieved state and chi2 (float32 sums in another order)."""
    from spectrobot_tpu_torch import cli
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("the mesh across cards needs two cards or more")
    m_ray = 2 if n % 2 == 0 and n >= 4 else 1
    meshes = {"forward": ["-o", f"compute.mesh_nu={n}", "-o",
                          "compute.mesh_halo=true"],
              "retrieve": ["-o", f"compute.mesh_ray={m_ray}", "-o",
                           f"compute.mesh_nu={n // m_ray}"]}
    common = ["-o", "compute.cutoff_cm1=10"]
    env = {**os.environ, "PYTHONPATH": REPO}
    for cmd, mesh in meshes.items():
        assert cli.main([cmd, SCENE, "-o", f"run.output_dir={tmp_path}/one",
                         *common]) == 0
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             f"--nproc_per_node={n}", "-m", "spectrobot_tpu_torch", cmd,
             SCENE, "-o", f"run.output_dir={tmp_path}/mesh", *common, *mesh],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-4000:]
    one = np.load(tmp_path / "one" / "forward.npz")["values"]
    got = np.load(tmp_path / "mesh" / "forward.npz")["values"]
    print(f"forward on {n} cards vs one: max |err| "
          f"{np.abs(got - one).max():.3e} of max {np.abs(one).max():.3e}")
    np.testing.assert_allclose(got, one, rtol=1e-4,
                               atol=1e-5 * np.abs(one).max())
    one = np.load(tmp_path / "one" / "retrieval.npz")
    got = np.load(tmp_path / "mesh" / "retrieval.npz")
    print(f"retrieve on {n} cards vs one: x max rel err "
          f"{np.abs(got['x'] - one['x']).max() / np.abs(one['x']).max():.3e}"
          f", chi2 {float(got['chi2']):.6g} vs {float(one['chi2']):.6g}, "
          f"{int(got['n_iter'])} vs {int(one['n_iter'])} LM iterations")
    assert int(got["n_iter"]) == int(one["n_iter"])
    assert bool(got["converged"]) and bool(one["converged"])
    np.testing.assert_allclose(got["x"], one["x"], rtol=1e-4)
    np.testing.assert_allclose(got["chi2"], one["chi2"], rtol=1e-4)


def test_halo_exchange_overlaps_on_every_card(cuda, tmp_path):
    """``python -m spectrobot_tpu_torch.halo_overlap --scene slice`` on the
    machine's n cards (one rank a card; the slice at a 10 cm-1 cutoff on
    (1, 1, n) and, from 4 cards, (1, 2, n/2)): every traced forward makes
    one exchange launch (every hop's messages in one batch), and every
    rank ran it on another stream than its line sums, started before its
    own line sum ended and with a compute kernel in its in-flight window;
    the radiances equal one card's within chip_smoke.py's MESH_RTOL."""
    import json
    mesh_rtol = 1e-5
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("the exchange across cards needs two cards or more")
    out = tmp_path / "halo_overlap.json"
    proc = subprocess.run(
        [sys.executable, "-m", "spectrobot_tpu_torch.halo_overlap",
         "--scene", "slice", "--json-out", str(out)], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
        text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(out.read_text())
    print(res["topology"])
    assert res["n_ranks"] == n
    for run in res["runs"]:
        assert len(run["ranks"]) == n
        for r in run["ranks"]:
            print(run["mesh"], r["rank"], json.dumps(r["summary"]),
                  json.dumps(r["vs_single_device"]))
            assert [f["n_exchange_launches"] for f in r["forwards"]] == [
                1] * len(r["forwards"])
            assert r["summary"]["kernels_overlapped_in_flight_window"] >= 1
            assert r["summary"]["async_pairs_emitted"] is True
            assert r["vs_single_device"]["worst_ratio"] <= mesh_rtol


def test_retrieve_mixes_replays_with_eager_collectives_on_every_card(
        cuda, tmp_path):
    """``torchrun`` of the CLI retrieve in the nu-halo tier on the
    machine's n cards, on (1, 1, n) and, from 4 cards, (1, 2, n/2), against
    the single-card retrieve (examples/mars_limb.toml at a 10 cm-1 cutoff,
    float32): each LM iteration's eager ``jacfwd`` Jacobian and
    normal-equation all-reduces (NCCL) run between replays of the graphed
    forward (its exchange on the capture ring), so at least two
    iterations mean replays after eager collectives.  Each run ends
    within its timeout (no hang); the LM path is the same (iterations,
    convergence), the fitted spectrum within 1e-5 of its largest value of
    one card's, the state and chi2 within the 1e-4 of the CLI mesh test
    (float32 sums in another order)."""
    from spectrobot_tpu_torch import cli
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("the mesh across cards needs two cards or more")
    common = ["-o", "compute.cutoff_cm1=10"]
    assert cli.main(["retrieve", SCENE, "-o",
                     f"run.output_dir={tmp_path}/one", *common]) == 0
    one = np.load(tmp_path / "one" / "retrieval.npz")
    assert int(one["n_iter"]) >= 2
    shapes = [(1, 1, n)] + ([(1, 2, n // 2)] if n >= 4 and n % 2 == 0
                            else [])
    env = {**os.environ, "PYTHONPATH": REPO}
    for shape in shapes:
        out = tmp_path / f"mesh_{shape[1]}_{shape[2]}"
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             f"--nproc_per_node={n}", "-m", "spectrobot_tpu_torch",
             "retrieve", SCENE, "-o", f"run.output_dir={out}", *common,
             "-o", "compute.mesh_halo=true",
             "-o", f"compute.mesh_line={shape[1]}",
             "-o", f"compute.mesh_nu={shape[2]}"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        got = np.load(out / "retrieval.npz")
        y_err = np.abs(got["values"] - one["values"]).max() / np.abs(
            one["values"]).max()
        print(f"retrieve on {shape} vs one card: {int(got['n_iter'])} vs "
              f"{int(one['n_iter'])} LM iterations, fit max |err| / max "
              f"{y_err:.3e}, x max rel err "
              f"{np.abs(got['x'] - one['x']).max() / np.abs(one['x']).max():.3e}"
              f", chi2 {float(got['chi2']):.6g} vs {float(one['chi2']):.6g}")
        assert int(got["n_iter"]) == int(one["n_iter"])
        assert bool(got["converged"]) and bool(one["converged"])
        assert y_err <= 1e-5
        np.testing.assert_allclose(got["x"], one["x"], rtol=1e-4)
        np.testing.assert_allclose(got["chi2"], one["chi2"], rtol=1e-4)


@pytest.fixture(scope="module")
def graph_runs(tmp_path_factory):
    """tests/torch_mesh_cases.py:graph_card_case on every card (one rank a
    card): the meshes (1, 1, n) and, from 4 cards, (1, 2, n/2)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the mesh graphs run only on the card")
    import torch_mesh_cases as cases
    n = torch.cuda.device_count()
    shapes = [(1, 1, n)] + ([(1, 2, n // 2)] if n >= 4 and n % 2 == 0
                            else [])
    tmp = tmp_path_factory.mktemp("graph")
    return n, shapes, cases.run(tmp, n, cases.graph_card_case, str(tmp),
                                shapes, join_group=False)


def test_graph_replay_bit_equal_to_eager_body(graph_runs):
    """The mesh forward in both tiers and the K3 halo accumulation through
    their CUDA graphs, on two states in turn: the first call (eager, then
    captured) and four replays, each bit-equal to the eager body on the
    same inputs; one graph and four replays."""
    n, shapes, got = graph_runs
    names = {f"{tier} {s}" for s in shapes for tier in ("psum", "nu-halo")}
    for rank, out in enumerate(got):
        assert set(out) == names | {"K3 halo"}
        for name, rec in out.items():
            print(rank, name, rec["calls"], rec["pool_bytes"])
            assert [c[0] for c in rec["calls"]] == [True] * 5, name
            assert (rec["graphs"], rec["replays"]) == (1, 4), name


def test_graph_replay_launches_each_kernel_once_a_source(graph_runs):
    """K1 (K3 in the halo accumulation) once a line source and call, the
    replays as the eager first call: 1 + the nu-halo hops; a replay with
    hops also launches the ring kernel once (its exchange, every hop in
    one launch, where the eager call's is NCCL's); a replay's counts are
    the kernels its profiler trace shows."""
    from spectrobot_tpu_torch.parallel.halo import _hops
    n, _, got = graph_runs
    for out in got:
        for name, rec in out.items():
            if name == "K3 halo":
                hops = len(_hops(n))
                want = {"cuda_single.LAUNCHES": 1 + hops}
            else:
                tier, shape = name.split(" ", 1)
                n_nu = int(shape.strip("()").split(",")[2])
                hops = len(_hops(n_nu)) if tier == "nu-halo" else 0
                want = {"cuda_opacity.LAUNCHES": 1 + hops}
            replay = {**want, **({"cuda_dma.RING_LAUNCHES": 1} if hops
                                 else {})}
            assert [c[1] for c in rec["calls"]] == [want] + [replay] * 4, \
                name
            assert rec["traced"] == replay, name


def test_mesh_jacobian_stays_eager(graph_runs):
    """torch.func.jacfwd through the graphed mesh function runs its body
    eagerly: no capture, no replay, bit-equal to jacfwd of the body."""
    _, _, got = graph_runs
    for out in got:
        for name, rec in out.items():
            if name == "K3 halo":
                continue
            jac = rec["jacobian"]
            before, after = jac["graphs_replays"]
            assert before == after == (1, 4), name
            assert jac["equal_to_body"] and jac["finite"], name


# ---------------------------------------------------------------------------
# The remote-copy tier (csrc/dma_ring.cu, csrc/dma_halo.cu): the loopback
# ring on one card, and the ranks of a torchrun ring across the cards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("direction", [1, -1])
def test_dma_ring_matches_roll(cuda, n, direction):
    """The ring kernel on the loopback ring: bit-equal to the roll of the
    blocks, with 16-byte and 4-byte copies (blocks of 999 and 15005 floats)
    and a ragged last chunk, across a regrowth of the workspace (the last
    block), twice in a row (the epoch protocol across calls); one launch
    per call."""
    from spectrobot_tpu_torch.ops import cuda_dma
    from spectrobot_tpu_torch.parallel.peer import loopback_ring
    ring = loopback_ring(n, cuda)
    g = torch.Generator(device=cuda).manual_seed(n)
    for shape in ((8, 128), (3, 333), (5, 3001), (64, 4096)):
        x = torch.randn((n,) + shape, generator=g, device=cuda)
        for _ in range(2):
            before = cuda_dma.RING_LAUNCHES
            got = cuda_dma.ring_exchange_cuda(ring, x, direction)
            torch.cuda.synchronize()
            assert cuda_dma.RING_LAUNCHES == before + 1
            assert torch.equal(got, torch.roll(x, direction, 0))
    ring.close()


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_dma_ring_back_to_back(cuda, n):
    """50 calls in a row with no synchronisation between them, the two
    directions in turns, at blocks of 1001 floats (not a multiple of 4 or
    of a chunk): each call waits for its own epoch's flags, and every
    result is the roll."""
    from spectrobot_tpu_torch.ops import cuda_dma
    from spectrobot_tpu_torch.parallel.peer import loopback_ring
    ring = loopback_ring(n, cuda)
    g = torch.Generator(device=cuda).manual_seed(10 + n)
    xs = [torch.randn((n, 7, 143), generator=g, device=cuda)
          for _ in range(50)]
    dirs = [1 if i % 2 else -1 for i in range(50)]
    outs = [cuda_dma.ring_exchange_cuda(ring, x, d)
            for x, d in zip(xs, dirs)]
    torch.cuda.synchronize()
    assert ring.epoch == 50
    for x, d, got in zip(xs, dirs, outs):
        assert torch.equal(got, torch.roll(x, d, 0))
    ring.close()


@pytest.mark.parametrize("n", [1, 3, 4])
def test_captured_ring_exchange_counts_its_epoch_on_the_card(cuda, n):
    """The capture ring's transport on the loopback ring (a ring on the
    device's epoch): both directions in one launch, bit-equal to the two
    rolls, eagerly and through a CUDA graph replayed three times on new
    blocks (15005 floats: 4-byte copies, several chunks); the count of
    calls read back from the card moves by one a launch (not at the
    capture), and the host counts none."""
    from spectrobot_tpu_torch.ops import cuda_dma
    from spectrobot_tpu_torch.parallel.peer import Ring
    ring = Ring(n, cuda, on_device=True)
    g = torch.Generator(device=cuda).manual_seed(30 + n)
    x = torch.randn((n, 5, 3001), generator=g, device=cuda)
    ring.reserve(x.numel() // n)
    rolls = lambda v: torch.stack([torch.roll(v, 1, 0), torch.roll(v, -1, 0)])
    before = cuda_dma.RING_LAUNCHES
    got = cuda_dma.ring_exchange_hops(ring, x, (1, -1))
    torch.cuda.synchronize()
    assert cuda_dma.RING_LAUNCHES == before + 1
    assert torch.equal(got, rolls(x)) and ring.device_calls() == 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cuda_dma.ring_exchange_hops(ring, x, (1, -1))
    assert ring.device_calls() == 1
    for i in range(3):
        x.copy_(torch.randn(x.shape, generator=g, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, rolls(x)), i
        assert ring.device_calls() == 2 + i
    got = cuda_dma.ring_exchange_hops(ring, x, (-1,))
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.roll(x, -1, 0))
    assert ring.device_calls() == 5 and ring.epoch == 0
    del graph
    ring.close()


DMA_VARIANTS = ("sorted", "unsorted", "ragged", "one row", "eight rows")


def _dma_scene(device, n, cutoff, variant="sorted"):
    """tests/test_dma_halo.py's fused case (500 lines, 1024 points) in the
    port, partitioned over ``n`` shards; ``variant``: each shard's row
    (padding included) shuffled ("unsorted"), P_loc = 1001 and L not a
    multiple of 128 ("ragged"), or 1 or 8 random amplitude rows."""
    from spectrobot_tpu_torch.data.lines import random_lines
    from spectrobot_tpu_torch.ops.opacity import line_kernel_inputs
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist
    from spectrobot_tpu_torch.parallel import halo
    rng = np.random.default_rng(20 + n)
    dl = device_lines_from_linelist(random_lines(500, 580.0, 720.0, seed=3),
                                    [(2, 1)], dtype=torch.float32,
                                    device=device, nu_ref=0.0)
    n_out = {"one row": 1, "eight rows": 8}.get(variant, 2)
    w = rng.uniform(0.5, 1.5, (n_out, dl.n_lines)) if n_out != 2 else \
        np.ones((2, dl.n_lines))
    kl = line_kernel_inputs(dl, 210.0, 120.0, 40.0,
                            amp_weights=torch.as_tensor(
                                w, dtype=torch.float32, device=device))
    nu = np.linspace(600.0, 700.0, 1001 * n if variant == "ragged" else 1024)
    edges = halo.nu_shard_edges(nu, n, cutoff)
    skl = halo.partition_kernel_lines(
        kl, dl.nu0, edges, round_to=1 if variant == "ragged" else 128)
    if variant == "unsorted":
        perm = torch.as_tensor(np.stack([rng.permutation(skl.nu_c.shape[1])
                                         for _ in range(n)]), device=device)
        skl = halo.ShardedKernelLines(
            *(torch.gather(a, -1, perm if a.dim() == 2 else perm[:, None]
                           .expand_as(a)) for a in skl))
    return torch.as_tensor(nu, dtype=torch.float32, device=device), skl


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("cutoff", [10.0, None])
@pytest.mark.parametrize("variant", DMA_VARIANTS)
def test_dma_halo_matches_plain(cuda, n, cutoff, variant):
    """The fused kernel on the loopback ring against its plain version
    (own lines plus each hop's), within K1's budget, on sorted and
    shuffled rows, ragged lengths and 1, 2 or 8 amplitude rows; one launch
    per call, bit-equal from call to call, the entry point equal to the
    wrapper on the packed rows."""
    from spectrobot_tpu_torch import dma_halo
    from spectrobot_tpu_torch.ops import cuda_dma
    from spectrobot_tpu_torch.parallel import halo
    from spectrobot_tpu_torch.parallel.peer import loopback_ring
    nu, skl = _dma_scene(cuda, n, cutoff, variant)
    ring = loopback_ring(n, cuda)
    f = dma_halo.fused_halo_accumulate_fn(ring, cutoff_cm1=cutoff)
    outs = []
    for _ in range(2):
        before = cuda_dma.HALO_LAUNCHES
        outs.append(f(nu, skl))
        torch.cuda.synchronize()
        assert cuda_dma.HALO_LAUNCHES == before + 1
    assert torch.equal(outs[0], outs[1])
    packed = halo.pack_lines(halo.KernelLines(*skl))
    n_out = packed.shape[1] - 3
    ref = cuda_dma.fused_halo_accumulate_plain(
        ring, nu.reshape(n, -1), packed, cutoff_cm1=cutoff)
    ref = ref.transpose(0, 1).reshape(n_out, -1)
    torch.testing.assert_close(outs[0], ref, rtol=3e-5,
                               atol=1e-6 * float(ref.abs().max()))
    got = cuda_dma.fused_halo_accumulate_cuda(ring, nu.reshape(n, -1),
                                              packed, cutoff_cm1=cutoff)
    assert torch.equal(got.transpose(0, 1).reshape(n_out, -1), outs[0])
    ring.close()


def test_dma_halo_wrapper_only_allocates(cuda):
    """On ragged shapes the fused wrappers (packed rows, and rows held
    apart) allocate the output and launch the kernel once, with no other
    tensor operation: no pads, no slice, no layout pass (the scratch and
    the counters are kept per stream); the counters are left zero."""
    from spectrobot_tpu_torch.ops import cuda_dma
    from spectrobot_tpu_torch.parallel import halo
    from spectrobot_tpu_torch.parallel.peer import loopback_ring
    nu, skl = _dma_scene(cuda, 4, 10.0, "ragged")
    ring = loopback_ring(4, cuda)
    nu4 = nu.reshape(4, -1)
    lines = halo.KernelLines(*skl)
    packed = halo.pack_lines(lines)
    for call in (lambda: cuda_dma.fused_halo_accumulate_cuda(
                     ring, nu4, packed, cutoff_cm1=10.0),
                 lambda: cuda_dma.fused_halo_accumulate_lines(
                     ring, nu4, lines, cutoff_cm1=10.0)):
        before = cuda_dma.HALO_LAUNCHES
        assert _tensor_ops(call) == ["aten.empty.memory_format"]
        assert cuda_dma.HALO_LAUNCHES == before + 2
    torch.cuda.synchronize()
    assert all(int(c.abs().sum()) == 0
               for c in cuda_dma._COUNTERS.values())
    ring.close()


def test_dma_ring_halo_lines_match_roll(cuda):
    from spectrobot_tpu_torch import dma_halo
    from spectrobot_tpu_torch.parallel.peer import loopback_ring
    _, skl = _dma_scene(cuda, 4, 10.0)
    ring = loopback_ring(4, cuda)
    for _ in range(2):
        left, right = dma_halo.ring_halo_lines(ring, skl)
        for got, shift in ((left, 1), (right, -1)):
            for g, a in zip(got, skl):
                assert torch.equal(g, torch.roll(a, shift, 0))
    ring.close()


def test_dma_tier_on_every_card(cuda):
    """``torchrun --nproc_per_node=n -m spectrobot_tpu_torch.dma_halo`` on
    the machine's n cards: the ring exchange bit-equal to ring_shift (the
    dense case's packed rows and a 64 MB block per rank), the fused halo sum
    within K1's budget of the single-card plain sum; then with one rank
    that never launches, its neighbours end in a CUDA error within the
    spin timeout instead of hanging."""
    import json
    import time
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("the ring across cards needs two cards or more")
    env = {**os.environ, "PYTHONPATH": REPO}
    run = [sys.executable, "-m", "torch.distributed.run",
           f"--nproc_per_node={n}", "-m", "spectrobot_tpu_torch.dma_halo"]
    proc = subprocess.run(run, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(res))
    assert len(res["ranks"]) == n
    for r in res["ranks"]:
        assert r["ring packed rows"]["bit_equal"] and r["ring block"][
            "bit_equal"]
        assert r["fused halo"]["vs_single_card_plain"]["fused"][
            "err_over_budget"] <= 1.0
    t0 = time.time()
    proc = subprocess.run(run + ["--missing-peer", str(n - 1)], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    elapsed = time.time() - t0
    print(proc.stdout[-3000:])
    assert proc.returncode != 0
    assert "ended in a CUDA error" in proc.stdout, proc.stderr[-3000:]
    assert elapsed < 120


# ---------------------------------------------------------------------------
# The (P, T) table tier (ops/lut.py): its builds run K1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["lte", "nlte"])
def test_lut_build_runs_k1(cuda, tier):
    """A table build on the card is one K1 launch (two rows a state: two
    species, or 3G non-LTE rows), within K1's budget of the plain build;
    the table forward and its Jacobian launch no line-sum kernel."""
    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch.ops import lut
    from spectrobot_tpu_torch.retrieval.state import flatten_state, make_state

    ov = {"grid.nu_min": "2320.0", "grid.nu_max": "2360.0",
          "grid.n_points": "512", "scene.n_levels": "9",
          "scene.species": "CO2,CO",       # CO: a row with no lines here
          "lines.source": "synthetic:co2_43um,co2_43um_hot",
          "geometry.tangent_heights_km": "40.0,70.0",
          "compute.use_lut": "true", "compute.lut_n_T": "6",
          "compute.lut_n_p": "7"}
    if tier == "nlte":
        ov.update({"nlte.enabled": "true", "nlte.t_vib": "demo:co2_pump"})
    cfg = cli.load_config(None, ov)
    before = co.LAUNCHES
    scene = cli.build_scene(cfg, cuda)
    torch.cuda.synchronize()
    assert co.LAUNCHES == before + 1
    build = lut.build_nlte_lut if tier == "nlte" else lut.build_lut
    plain = build(scene.nu, scene.lines, 2, engine=cb.PLAIN,
                  **cli.lut_lattice(cfg, scene.atm, scene.species_names,
                                    scene.chi, scene.nu_off))
    tables = ("sigma_l", "sigma_u", "sigma_e") if tier == "nlte" else (
        "sigma",)
    for f in tables:
        got, ref = getattr(scene.lut, f), getattr(plain, f)
        assert float(ref.abs().max()) > 0.0
        torch.testing.assert_close(got, ref, rtol=3e-5,
                                   atol=1e-6 * float(ref.abs().max()))
    atm = scene.atm.to(torch.float32)
    x0, unravel = flatten_state(make_state(atm, []))
    fwd = cli.scene_forward(cfg, scene, atm)
    k1, k2 = co.LAUNCHES, cb.LAUNCHES
    J = torch.func.jacfwd(lambda x: fwd(unravel(x)))(x0)
    torch.cuda.synchronize()
    assert (co.LAUNCHES, cb.LAUNCHES) == (k1, k2)
    assert bool(torch.isfinite(J).all()) and float(J.abs().max()) > 0.0


def test_fma_peak_runs(cuda):
    """The measurement kernel csrc/fma_peak.cu: one launch a call,
    bit-equal to its plain chain (fmaf emulated exactly), and a finite
    FP32 FMA ceiling from the bench's timing."""
    from spectrobot_tpu_torch import bench
    from spectrobot_tpu_torch.ops import cuda_fma

    x = torch.rand(1 << 16, device=cuda) + 0.5
    for depth in cuda_fma.DEPTHS:
        before = cuda_fma.LAUNCHES
        got = cuda_fma.fma_chain(x, bench.FMA_A, bench.FMA_B, depth)
        torch.cuda.synchronize()
        assert cuda_fma.LAUNCHES == before + 1
        ref = cuda_fma.fma_chain_plain(x, bench.FMA_A, bench.FMA_B, depth)
        assert torch.equal(got, ref)
    peak, rates, n = bench.fma_ceiling(cuda, n_rep=1)
    assert np.isfinite(peak) and peak > 0 and set(rates) == {64, 256}
