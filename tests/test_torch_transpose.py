"""The reverse-mode line sum of the PyTorch port against the JAX reference:
the plain transpose (K5's plain version) against ``_tangent_transpose``,
the rev op's gradients against the reference's custom-VJP op with the
Pallas kernels K1/K5 in interpret mode, the transposed window table, the
adjoint identity of the plain K2 and K5, and torch.func.jacrev against
jacfwd with its one folded transpose call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.synth import co2_15um_band, random_lines
from spectrobot_tpu.ops import opacity as jop
from spectrobot_tpu.ops import pallas_opacity as jpo
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu_torch import interop
from spectrobot_tpu_torch.ops import cuda_basis as cb
from spectrobot_tpu_torch.ops import cuda_opacity as co
from spectrobot_tpu_torch.ops import opacity as top
from spectrobot_tpu_torch.ops.cuda_transpose import (
    basis_transpose_batch, basis_transpose_batch_plain)

CPU = torch.device("cpu")
# These tests run tiny tensors: torch's intra-op threads would only
# contend (and spin-wait) with the other test workers for the cores.
torch.set_num_threads(1)


def _states(n_states, n_lines=150, seed=0, dtype=np.float32):
    """``n_states`` line states of ``n_lines`` random lines (one band over
    600-640 cm-1, slightly shifted and broadened per state), amps [B, 2, L],
    a random chi per line, the grid (300 points) and the unshifted
    centers."""
    dl = j_stage(random_lines(n_lines, 600.0, 640.0, seed=seed), [(2, 1)],
                 dtype=jnp.float64, nu_ref=0.0)
    kl = jop.line_kernel_inputs(dl, 220.0, 500.0, 50.0,
                                amp_weights=jnp.ones((2, n_lines)))
    rng = np.random.default_rng(seed + 10)
    b = np.arange(n_states)[:, None]
    nc = np.asarray(kl.nu_c) + 0.01 * b
    sx = np.asarray(kl.scale_x) * (1 + 0.05 * b)
    y = np.asarray(kl.y) * (1 + 0.1 * b)
    amps = np.asarray(kl.amps)[None] * rng.uniform(0.5, 2.0, (n_states, 2, 1))
    chi = rng.uniform(0.0, 0.3, (n_states, n_lines))
    nu = np.linspace(605.0, 635.0, 300)
    cast = lambda a: np.asarray(a, dtype)
    return (cast(nu), np.asarray(dl.nu0, np.float32), cast(nc), cast(sx),
            cast(y), cast(amps), cast(chi))


@pytest.mark.parametrize("with_chi", [False, True])
def test_tangent_transpose_plain_matches_jax(with_chi):
    """The plain transpose and its epilogue against the reference's jnp
    transpose, one state per call, float64; the batched plain K5 gives each
    state's projections."""
    nu, _, nc, sx, y, amps, chi = _states(3, dtype=np.float64)
    ct = np.random.default_rng(5).normal(size=(3, 2, nu.shape[0]))
    t = torch.as_tensor
    batch = basis_transpose_batch_plain(
        t(nu), t(nc), t(sx), t(y), t(ct),
        chi_b=t(chi) if with_chi else None)
    for b in range(3):
        cb_ = chi[b] if with_chi else None
        ref = jop._tangent_transpose(
            *(jnp.asarray(a) for a in (nu, nc[b], sx[b], y[b], amps[b],
                                       ct[b])),
            None if cb_ is None else jnp.asarray(cb_), chunk=64,
            variant="humlicek4", cutoff_cm1=25.0)
        Ab = top.tangent_transpose_plain(
            t(nu), t(nc[b]), t(sx[b]), t(y[b]), t(ct[b]),
            None if cb_ is None else t(cb_), chunk=64)
        got = top.transpose_epilogue(t(sx[b]), t(amps[b]), *Ab)
        for g, r in zip(got, ref):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-10,
                                       atol=1e-12 * np.abs(r).max())
        for a, one in zip(batch, Ab):
            np.testing.assert_allclose(a[b].numpy(), one.numpy(), rtol=1e-12,
                                       atol=1e-14 * float(one.abs().max()))


def _jax_rev_op(nu, nu0, with_chi):
    w = jpo.static_windows(nu, nu0, cutoff_cm1=25.0)
    wT = jpo.static_windows_T(nu, nu0, cutoff_cm1=25.0)
    return jop.make_accumulate_op(mode="rev", engine="pallas",
                                  interpret=True, cutoff_cm1=25.0, windows=w,
                                  windows_T=wT, has_chi=with_chi)


@pytest.mark.parametrize("with_chi,n_states", [(False, 1), (False, 2),
                                               (True, 2)])
def test_rev_op_gradients_match_pallas_interpret(with_chi, n_states):
    """Gradients of a weighted sum of the port's rev op (plain engine, its
    states batched explicitly) against the reference's custom-VJP op on the
    Pallas kernels (K1 primal, K5 backward) in interpret mode, float32: one
    state unbatched, and two states under a structural vmap.  The weights
    (the cotangent) are positive, as a chi-square's residual weights are
    near a fit; random signs cancel the float32 point sums of both sides to
    a few 1e-6 of the largest gradient."""
    nu, nu0, nc, sx, y, amps, chi = _states(n_states)
    wgt = np.random.default_rng(3).uniform(
        0.5, 1.5, (n_states, 2, nu.shape[0])).astype(np.float32)
    op_j = _jax_rev_op(nu, nu0, with_chi)

    def loss_j(nc, sx, y, am, cb_):
        one = lambda *a: op_j(jnp.asarray(nu), *a)
        args = (nc, sx, y, am) + ((cb_,) if with_chi else ())
        out = (one(*(a[0] for a in args))[None] if n_states == 1
               else jax.vmap(one)(*args))
        return jnp.sum(jnp.asarray(wgt) * out)

    g_ref = jax.grad(loss_j, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (nc, sx, y, amps, chi)))
    t = lambda a: torch.tensor(a, requires_grad=True)
    args = [t(a) for a in (nc, sx, y, amps)]
    op = top.LineSumOp(cb.PLAIN, None, 25.0, "rev")
    out = op(torch.as_tensor(nu), *args,
             torch.as_tensor(chi) if with_chi else None)
    got = torch.autograd.grad(torch.sum(torch.as_tensor(wgt) * out), args)
    # The reference's budgets: tests/test_pallas_jacobian.py:215 without
    # chi, tests/test_chi.py:140 with it.
    rtol, atol = (2e-4, 1e-5) if with_chi else (2e-5, 2e-6)
    for g, r in zip(got, g_ref):
        r = np.asarray(r)
        assert g.shape == r.shape and np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), r, rtol=rtol,
                                   atol=atol * np.abs(r).max())


@pytest.mark.parametrize("cutoff", [25.0, 5.0, None])
@pytest.mark.parametrize("tile_p,block_l", [(128, 128), (256, 128)])
def test_transposed_windows_match_jax(tile_p, block_l, cutoff):
    rng = np.random.default_rng(0)
    nu = np.linspace(-40.0, 40.0, 1500).astype(np.float32)
    nu0 = np.sort(rng.uniform(-70.0, 70.0, 700)).astype(np.float32)
    got = co.static_windows_T(nu, nu0, tile_p=tile_p, block_l=block_l,
                              cutoff_cm1=cutoff)
    ref = jpo.static_windows_T(nu, nu0, tile_p=tile_p, block_l=block_l,
                               cutoff_cm1=cutoff)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    if (tile_p, block_l) != (co.TILE_P, co.BLOCK_L):
        return
    # The scene's table carries them, and K5 visits the (tile, line block)
    # pairs K1 and K2 visit.
    w = co.line_windows(nu, nu0, cutoff_cm1=cutoff)
    np.testing.assert_array_equal(w.starts_T.numpy(), got[0])
    np.testing.assert_array_equal(w.counts_T.numpy(), got[1])
    by_tile = {(t, b) for t, (s, c) in enumerate(zip(w.starts, w.counts))
               for b in range(int(s), int(s + c))}
    by_block = {(t, b) for b, (s, c) in enumerate(zip(w.starts_T,
                                                      w.counts_T))
                for t in range(int(s), int(s + c))}
    assert by_tile == by_block


@pytest.mark.parametrize("with_chi", [False, True])
def test_plain_adjoint_identity(with_chi):
    """<ct, K2(C)> = sum_k <C_k, K5(ct)_k> for the plain versions, float64:
    the transpose is the adjoint of the contraction."""
    nu, _, nc, sx, y, amps, chi = _states(3, dtype=np.float64)
    rng = np.random.default_rng(7)
    R = 4
    C = [rng.normal(size=(3, R, nc.shape[1])) * amps[:, :1] for _ in range(4)]
    ct = rng.normal(size=(3, R, nu.shape[0]))
    t = torch.as_tensor
    kw = dict(chi_b=t(chi) if with_chi else None)
    out = cb.basis_contract_batch_plain(t(nu), t(nc), t(sx), t(y),
                                        *(t(c) for c in C), **kw)
    Ab = basis_transpose_batch_plain(t(nu), t(nc), t(sx), t(y), t(ct), **kw)
    lhs = float(torch.sum(t(ct) * out))
    rhs = sum(float(torch.sum(t(c) * a)) for c, a in zip(C, Ab))
    assert lhs == pytest.approx(rhs, rel=1e-10)


class _CountingTranspose:
    """A transpose primitive that records the rows of every call."""

    def __init__(self):
        self.rows = []

    def __call__(self, *args, **kw):
        self.rows.append(args[5].shape[1])
        return cb.PLAIN.transpose(*args, **kw)


@pytest.mark.parametrize("transpose_rows,calls", [(None, [8]), (3, [3, 3, 2])])
def test_jacrev_matches_jacfwd_with_folded_calls(transpose_rows, calls):
    """torch.func.jacrev through the rev op, from the temperature through
    the strength/width prologue, equals jacfwd through the fwd op (float64;
    the reference's tests/test_analytic_jvp.py:134).  The jacrev folds its
    4 cotangents x 2 depths into one transpose call, or the fewest calls
    of at most ``transpose_rows`` rows."""
    from spectrobot_tpu_torch.ops.opacity import line_kernel_inputs

    dl = j_stage(co2_15um_band(j_max=8), [(2, 1)], dtype=jnp.float64,
                 nu_ref=0.0)
    tl = interop.device_lines_from_numpy(
        {k: np.asarray(v) for k, v in dl._asdict().items()}, device=CPU)
    nu = torch.as_tensor(np.linspace(662.0, 672.0, 200))
    count = _CountingTranspose()
    rev = top.LineSumOp(top.Engine("counting", cb.PLAIN.accumulate,
                                   cb.PLAIN.contract, count, transpose_rows),
                        None, 25.0, "rev")
    fwd = top.LineSumOp(cb.PLAIN, None, 25.0, "fwd")
    p = torch.as_tensor([[300.0], [120.0]], dtype=torch.float64)

    def f(op):
        def g(T):                       # 2 states -> 4 outputs at one point
            kl = line_kernel_inputs(tl, T[:, None], p, 50.0,
                                    torch.ones(2, 2, tl.n_lines,
                                               dtype=torch.float64))
            return op(nu, kl.nu_c, kl.scale_x, kl.y, kl.amps)[:, :, 100]
        return g

    T0 = torch.as_tensor([230.0, 180.0], dtype=torch.float64)
    Jf = torch.func.jacfwd(f(fwd))(T0)
    Jr = torch.func.jacrev(f(rev))(T0)
    assert count.rows == calls
    np.testing.assert_allclose(Jr.numpy(), Jf.numpy(), rtol=1e-9,
                               atol=1e-12 * float(Jf.abs().max()))


def test_rev_op_refuses_forward_mode():
    nu = torch.linspace(-5.0, 5.0, 16, dtype=torch.float64)
    op = top.LineSumOp(cb.PLAIN, None, 25.0, "rev")
    lines = torch.ones(2, 4, dtype=torch.float64)
    amps = torch.ones(2, 2, 4, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="no forward-mode"):
        torch.func.jvp(lambda a: op(nu, lines, lines, lines, a), (amps,),
                       (amps,))
    with pytest.raises(ValueError, match="analytic_jvp"):
        top.ad_mode("both")


def test_cpu_transpose_never_launches():
    from spectrobot_tpu_torch.ops import cuda_transpose as ctr

    nu, nu0, nc, sx, y, _, _ = _states(2)
    ct = np.random.default_rng(1).normal(size=(2, 2, nu.shape[0]))
    t = torch.as_tensor
    before = ctr.LAUNCHES
    got = basis_transpose_batch(t(nu), co.line_windows(t(nu), nu0), t(nc),
                                t(sx), t(y), t(ct.astype(np.float32)))
    assert ctr.LAUNCHES == before
    ref = basis_transpose_batch_plain(t(nu), t(nc), t(sx), t(y),
                                      t(ct.astype(np.float32)))
    for g, r in zip(got, ref):
        assert g.shape == (2, 2, nc.shape[1]) and torch.equal(g, r)


# ---------------------------------------------------------------------------
# K5's segments: how the kernel cuts each line block's window of tiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_states,n_points,n_lines,n_rows", [
    (640, 8192, 121, 2), (620, 8192, 2048, 2), (1, 16384, 20480, 2),
    (1, 3001, 120, 2), (96, 8192, 121, 2), (640, 8192, 121, 66),
    (1, 3001, 120, 10)])
def test_transpose_segments_make_the_block_target(n_states, n_points,
                                                  n_lines, n_rows):
    """Every tile of the longest window falls in exactly one segment, none
    is empty, and the segments are the shortest whose count stays within
    the TARGET_BLOCKS thread blocks' share of each (line block, state), so
    the grid makes at least half the target, or one block per tile of
    every window where that is fewer."""
    from spectrobot_tpu_torch.ops import cuda_transpose as ctr

    win = co.line_windows(np.linspace(0.0, 100.0, n_points),
                          np.linspace(0.0, 100.0, n_lines), cutoff_cm1=None)
    n_lblk = win.starts_T.shape[0]
    assert win.max_tiles == win.nu_pad.shape[0] // co.TILE_P
    n_seg, seg_tiles = ctr.segments(win, n_states, n_rows)
    assert (n_seg - 1) * seg_tiles < win.max_tiles <= n_seg * seg_tiles
    items = n_lblk * n_states * ctr.row_chunks(n_rows)
    assert ctr.row_chunks(n_rows) == (1 if n_rows <= 2 else -(-n_rows // 8))
    share = -(-ctr.TARGET_BLOCKS // items)
    assert n_seg <= share
    assert seg_tiles == 1 or -(-win.max_tiles // (seg_tiles - 1)) > share
    assert 2 * items * n_seg >= min(ctr.TARGET_BLOCKS,
                                    items * win.max_tiles)


@pytest.mark.parametrize("target,n_states", [(1, 640), (4096, 9000)])
def test_transpose_segments_one_segment(monkeypatch, target, n_states):
    """A block target the (line block, state) grid already meets gives one
    segment of the whole window (the kernel then writes its sums without a
    workspace)."""
    from spectrobot_tpu_torch.ops import cuda_transpose as ctr

    monkeypatch.setattr(ctr, "TARGET_BLOCKS", target)
    win = co.line_windows(np.linspace(0.0, 50.0, 8192),
                          np.linspace(0.0, 50.0, 121))
    assert ctr.segments(win, n_states) == (1, win.max_tiles)


@pytest.mark.parametrize("n_states", [1, 64, 640])
def test_transpose_segments_windows_of_one_tile(n_states):
    """Windows one tile long (a grid of one tile) make one segment of one
    tile, whatever the number of states."""
    from spectrobot_tpu_torch.ops import cuda_transpose as ctr

    win = co.line_windows(np.linspace(0.0, 1.0, 100),
                          np.linspace(0.0, 1.0, 300), cutoff_cm1=25.0)
    assert win.max_tiles == 1
    assert ctr.segments(win, n_states) == (1, 1)


def test_ablation_edits_apply():
    """python -m spectrobot_tpu_torch.ablate_line_sums takes parts out of
    K1 and K5 by text edits of the checkout's sources: each edit finds its
    text exactly once."""
    from spectrobot_tpu_torch import ablate_line_sums as ab
    from spectrobot_tpu_torch.kernels import build

    assert {"full", "no_voigt", "pts1", "no_skips", "no_basis",
            "no_split"} <= set(ab.EDITS)
    for name, edits in ab.EDITS.items():
        assert (name == "full") == (not edits), name
        for kernel, path, old, new in edits:
            assert kernel in ab.KERNELS
            text = (build.SOURCE_DIR / path).read_text()
            assert text.count(old) == 1, (name, path)
            assert old != new
