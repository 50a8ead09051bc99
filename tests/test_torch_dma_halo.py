"""The remote-copy halo tier of the port (spectrobot_tpu_torch/dma_halo.py,
ops/cuda_dma.py and parallel/peer.py; their plain versions on the CPU)
against the reference's retired tier (benchmarks/dma_halo.py, Pallas in
interpret mode on the emulated mesh, as tests/test_dma_halo.py runs it):
the ring roll, ring_halo_lines and the fused halo sum, each on the
loopback ring and on 2 and 4 gloo ranks; and the host side of the
protocol (the epoch, the one hop of two shards, the peer-access check)."""

import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.synth import random_lines
from spectrobot_tpu.ops.opacity import KernelLines as JKernelLines
from spectrobot_tpu.ops.opacity import line_kernel_inputs
from spectrobot_tpu.ops.strengths import device_lines_from_linelist
from spectrobot_tpu.parallel import halo as jhalo
from spectrobot_tpu_torch import dma_halo
from spectrobot_tpu_torch.ops import cuda_dma
from spectrobot_tpu_torch.ops.opacity import KernelLines, accumulate_plain
from spectrobot_tpu_torch.parallel import halo, peer
from spectrobot_tpu_torch.parallel.halo import ShardedKernelLines

import torch_mesh_cases as cases

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "reference_dma_halo", pathlib.Path(__file__).resolve().parent.parent
    / "benchmarks" / "dma_halo.py")
jdma = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jdma)

RING_SHARDS = (2, 4, 8)
FUSED_SHARDS = (1, 2, 4)
CUTOFF = 10.0


def _ring_x(n):
    return np.arange(n * 8 * 128, dtype=np.float32).reshape(n * 8, 128)


def _skl_np(skl):
    return tuple(np.array(a) for a in skl)


def _torch_skl(skl_np):
    return ShardedKernelLines(*(torch.as_tensor(a) for a in skl_np))


def _mesh(n):
    return jdma.nu_ring_mesh(jax.devices()[:n])


@pytest.fixture(scope="module")
def jax_refs():
    """The reference's results, once per ring size: the ring roll (n = 2,
    4, 8, both directions), ring_halo_lines (tests/test_dma_halo.py's
    300-line, 512-point case on 4 shards) and the fused halo sum (its
    500-line, 1024-point case, cutoff 10, block_l 128; n = 1, 2, 4)."""
    refs = {"ring": {}, "fused": {}}
    for n in RING_SHARDS:
        for d in (1, -1):
            f = jdma.ring_exchange(_mesh(n), "nu", d, interpret=True)
            refs["ring"][n, d] = np.asarray(f(jnp.asarray(_ring_x(n))))

    ll = random_lines(300, 600.0, 700.0, seed=5)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float32,
                                    nu_ref=0.0)
    kl = line_kernel_inputs(dl, 210.0, 100.0, 30.0, amp_weights=jnp.ones(
        (2, dl.n_lines), jnp.float32))
    nu = np.linspace(600.0, 700.0, 512)
    skl = jhalo.partition_kernel_lines(kl, np.asarray(dl.nu0),
                                       jhalo.nu_shard_edges(nu, 4, CUTOFF))
    left, right = jdma.ring_halo_lines(_mesh(4), skl, interpret=True)
    refs["halo_lines"] = (_skl_np(skl), _skl_np(left), _skl_np(right))

    ll = random_lines(500, 580.0, 720.0, seed=3)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=jnp.float32,
                                    nu_ref=0.0)
    kl = line_kernel_inputs(dl, 210.0, 120.0, 40.0,
                            amp_weights=jnp.ones((2, dl.n_lines)))
    kl32 = JKernelLines(*[None if a is None else a.astype(jnp.float32)
                          for a in kl])
    nu32 = np.linspace(600.0, 700.0, 1024).astype(np.float32)
    for n in FUSED_SHARDS:
        edges = jhalo.nu_shard_edges(nu32.astype(np.float64), n, CUTOFF)
        skl = jhalo.partition_kernel_lines(kl32, np.asarray(dl.nu0), edges,
                                           round_to=128)
        f = jdma.fused_halo_accumulate_fn(_mesh(n), block_l=128,
                                          cutoff_cm1=CUTOFF, interpret=True)
        refs["fused"][n] = (nu32, _skl_np(skl[:4]),
                            np.asarray(f(jnp.asarray(nu32), skl)))
    return refs


@pytest.fixture(scope="module")
def gloo(request, jax_refs, tmp_path_factory):
    """Each rank's results of the entry points on ``request.param`` gloo
    ranks (dma_case), on the reference's inputs."""
    n = request.param
    ring_xs = {"x": _ring_x(n)}
    halo_skl = jax_refs["halo_lines"][0] if n == 4 else None
    nu, skl, _ = jax_refs["fused"][n]
    return cases.run(tmp_path_factory.mktemp(f"dma{n}"), n, cases.dma_case,
                     ring_xs, halo_skl, (nu, skl, CUTOFF))


def _fused_tol(ref):
    # tests/test_dma_halo.py's budget against the single-device sum.
    return dict(rtol=5e-5, atol=np.abs(ref).max() * 1e-6)


# ---------------------------------------------------------------------------
# The ring roll
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", RING_SHARDS)
@pytest.mark.parametrize("direction", [1, -1])
def test_ring_loopback_matches_jax(jax_refs, n, direction):
    ring = peer.loopback_ring(n, "cpu")
    before = cuda_dma.RING_LAUNCHES
    got = dma_halo.ring_exchange(ring, "nu", direction)(
        torch.as_tensor(_ring_x(n)))
    assert cuda_dma.RING_LAUNCHES == before     # a CPU tensor: plain
    ref = jax_refs["ring"][n, direction]
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, np.roll(_ring_x(n).reshape(
        n, 8, 128), direction, axis=0).reshape(n * 8, 128))


@pytest.mark.parametrize("direction", [1, -1])
def test_ring_loopback_matches_jax_on_a_ragged_block(direction):
    """Three shards of 5 x 37 floats (185: not a multiple of 4 or of a
    copy item): the plain route of the port against the reference's ring
    kernel in interpret mode, bit for bit."""
    x = np.random.default_rng(9).normal(size=(15, 37)).astype(np.float32)
    ref = np.asarray(jdma.ring_exchange(_mesh(3), "nu", direction,
                                        interpret=True)(jnp.asarray(x)))
    ring = peer.loopback_ring(3, "cpu")
    got = dma_halo.ring_exchange(ring, "nu", direction)(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ring.epoch == 1


@pytest.mark.parametrize("gloo", [2, 4], indirect=True)
@pytest.mark.parametrize("direction", [1, -1])
def test_ring_gloo_matches_jax(jax_refs, gloo, direction):
    n = len(gloo)
    got = torch.cat([r["ring"]["x", direction] for r in gloo]).numpy()
    np.testing.assert_array_equal(got, jax_refs["ring"][n, direction])


# ---------------------------------------------------------------------------
# ring_halo_lines
# ---------------------------------------------------------------------------


def _check_halo_lines(got_left, got_right, jax_refs):
    _, left, right = jax_refs["halo_lines"]
    for got, ref in ((got_left, left), (got_right, right)):
        for name, g, r in zip(ShardedKernelLines._fields, got, ref):
            np.testing.assert_array_equal(np.asarray(g), r, name)


def test_ring_halo_lines_loopback_matches_jax(jax_refs):
    skl = _torch_skl(jax_refs["halo_lines"][0])
    ring = peer.loopback_ring(4, "cpu")
    left, right = dma_halo.ring_halo_lines(ring, skl)
    assert ring.epoch == 2              # one packed message per direction
    _check_halo_lines(left, right, jax_refs)
    np.testing.assert_array_equal(left.nu_c.numpy(),
                                  np.roll(skl.nu_c.numpy(), 1, axis=0))


@pytest.mark.parametrize("gloo", [4], indirect=True)
def test_ring_halo_lines_gloo_matches_jax(jax_refs, gloo):
    stack = lambda i: ShardedKernelLines(*(
        torch.stack([r["halo_lines"][i][f] for r in gloo])
        for f in range(4)))
    _check_halo_lines(stack(0), stack(1), jax_refs)


# ---------------------------------------------------------------------------
# The fused halo sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", FUSED_SHARDS)
def test_fused_loopback_matches_jax(jax_refs, n):
    nu, skl, ref = jax_refs["fused"][n]
    ring = peer.loopback_ring(n, "cpu")
    before = cuda_dma.HALO_LAUNCHES
    got = dma_halo.fused_halo_accumulate_fn(ring, cutoff_cm1=CUTOFF)(
        torch.as_tensor(nu), _torch_skl(skl))
    assert cuda_dma.HALO_LAUNCHES == before
    assert got.shape == ref.shape == (2, len(nu))
    np.testing.assert_allclose(got.numpy(), ref, **_fused_tol(ref))


@pytest.mark.parametrize("gloo", [2, 4], indirect=True)
def test_fused_gloo_matches_jax(jax_refs, gloo):
    _, _, ref = jax_refs["fused"][len(gloo)]
    got = torch.cat([r["fused"] for r in gloo], dim=-1).numpy()
    np.testing.assert_allclose(got, ref, **_fused_tol(ref))


# ---------------------------------------------------------------------------
# The host side of the protocol
# ---------------------------------------------------------------------------


def test_epoch_counts_up_once_per_call():
    """Every call on a ring counts one epoch, the value each flag of the
    call (each receiver's destination-free flag, each chunk's arrival
    flag) is set to and waited for, so no flag is ever reset; the fused
    sum counts one too."""
    ring = peer.loopback_ring(4, "cpu")
    x = torch.zeros(4, 8, 128)
    for i in range(3):
        cuda_dma.ring_exchange_cuda(ring, x, 1 if i % 2 else -1)
    assert ring.epoch == 3
    nu = torch.linspace(600.0, 640.0, 4 * 64).reshape(4, 64)
    packed = torch.zeros(4, 5, 300)
    packed[:, 0] = 1e9
    cuda_dma.fused_halo_accumulate_cuda(ring, nu, packed, cutoff_cm1=5.0)
    assert ring.epoch == 4
    assert ring.begin_call() == 5


@pytest.mark.parametrize("n_floats,n_loc", [
    (5 * 8192, 4), (64 * 1000, 2), (64 * 1000, 8), (1001, 3), (1, 1),
    (16 << 20, 1), (2 * 1024 * 264, 1)])
def test_ring_chunk_spreads_a_block_over_the_items(n_floats, n_loc):
    """A ring call's copy items: a multiple of MIN_CHUNK_FLOATS within
    [MIN_CHUNK_FLOATS, CHUNK_FLOATS] (so the workspace, whose buffers hold
    a multiple of MIN_CHUNK_FLOATS, has a flag for every chunk), the
    least such size that makes at most RING_ITEMS items (up to one more a
    shard for the rounding), unless CHUNK_FLOATS caps it."""
    c = peer.ring_chunk(n_floats, n_loc)
    M = peer.MIN_CHUNK_FLOATS
    assert c % M == 0 and M <= c <= peer.CHUNK_FLOATS
    items = lambda size: n_loc * -(-n_floats // size)
    if c < peer.CHUNK_FLOATS:
        assert items(c) <= peer.RING_ITEMS + n_loc
    if M < c < peer.CHUNK_FLOATS:
        assert items(c - M) > peer.RING_ITEMS
    cap = peer.workspace_cap(n_floats)                # workspace_for's
    assert -(-n_floats // c) <= cap // peer.MIN_CHUNK_FLOATS


# ---------------------------------------------------------------------------
# The fused kernel's host side: its window rule, segments and workspace
# ---------------------------------------------------------------------------


def _window_case(seed, n, L, P, n_pad):
    """n shards of a grid of n * P points over 610-690 cm-1 (float32 nu [n,
    P]) and of L lines each (packed [n, 5, L]): shard k's centers random
    within 5 cm-1 of its own interval, the last ``n_pad`` at the
    partition's padding center 1e9, then unsorted: the blocks of 128 lines
    in a random order and the lines shuffled within each block."""
    rng = np.random.default_rng(seed)
    edges = np.linspace(610.0, 690.0, n + 1)
    nuc = np.sort(rng.uniform(edges[:-1, None] - 5.0, edges[1:, None] + 5.0,
                              (n, L)), axis=1)
    nuc[:, L - n_pad:] = 1e9
    nb = -(-L // 128)
    for row in nuc:
        blocks = [row[b * 128:(b + 1) * 128].copy() for b in range(nb)]
        order = list(rng.permutation(nb - 1)) + [nb - 1]
        row[:] = np.concatenate([rng.permutation(blocks[b]) for b in order])
    packed = np.ones((n, 5, L))
    packed[:, 0] = nuc
    nu = np.linspace(610.0, 690.0, n * P).reshape(n, P)
    return (torch.as_tensor(nu, dtype=torch.float32),
            torch.as_tensor(packed, dtype=torch.float32))


@pytest.mark.parametrize("n,L,P", [(1, 3000, 1000), (2, 1000, 1001),
                                   (4, 1290, 383), (3, 640, 256)])
@pytest.mark.parametrize("cutoff", [0.5, 10.0])
def test_window_rule_skips_only_blocks_beyond_the_cutoff(n, L, P, cutoff):
    """The fused kernel's window rule, on unsorted centers with padding
    among them (L and P ragged): every (point, line) pair of a block it
    leaves out, for a tile of the shard and a block of any of the shard's
    sources (own, left, right), lies beyond the cutoff; a block that holds
    a line within the cutoff of a point of the tile is always in; and with
    no cutoff every block is in."""
    nu, packed = _window_case(n * L + P, n, L, P, n_pad=L // 7)
    within = cuda_dma.blocks_in_reach(nu, packed, cutoff)
    n_tiles, nb = -(-P // 128), -(-L // 128)
    srcs = [0] + [shift for shift, _ in halo._hops(n)]
    assert within.shape == (n, len(srcs), n_tiles, nb)
    pad_nu = torch.cat([nu, nu[:, -1:].expand(n, n_tiles * 128 - P)], -1)
    for i, shift in enumerate(srcs):
        centers = torch.roll(packed[:, 0], shift, 0)
        for k in range(n):
            for t in range(n_tiles):
                pts = pad_nu[k, t * 128:(t + 1) * 128]
                near = ((pts[:, None] - centers[k][None, :]).abs()
                        <= cutoff).any(0)
                near = torch.nn.functional.pad(near, (0, nb * 128 - L))
                holds = near.reshape(nb, 128).any(1)
                assert not (holds & ~within[k, i, t]).any()
    assert within.any() and not within.all()
    assert cuda_dma.blocks_visited(nu, packed, None) == (within.numel(),) * 2


def test_block_ranges_leave_out_lines_past_the_rows():
    """Each block's range is (min, max) over its own lines; a last block
    shorter than BLOCK_L ranges over the lines it has."""
    c = torch.arange(300, dtype=torch.float32).flip(0)
    rg = cuda_dma.block_ranges(c[None])
    assert rg.shape == (1, 3, 2)
    assert rg[0].tolist() == [[172.0, 299.0], [44.0, 171.0], [0.0, 43.0]]


def test_window_rule_on_sorted_rows_takes_the_blocks_within_reach():
    """On sorted centers with no padding (a shard's own rows) the blocks
    the rule keeps are those that hold a line within the cutoff of the
    tile, up to the rule's slack of 4 ulps."""
    nu, packed = _window_case(5, 1, 2000, 1000, n_pad=0)
    packed[0, 0] = packed[0, 0].sort().values
    for cutoff in (0.5, 3.0):
        within = cuda_dma.blocks_in_reach(nu, packed, cutoff)[0, 0]
        for t in range(within.shape[0]):
            pts = nu[0, t * 128:(t + 1) * 128]
            d = (pts[:, None] - packed[0, 0][None, :]).abs().min(0).values
            d = torch.nn.functional.pad(d, (0, 16 * 128 - 2000),
                                        value=math.inf)
            gap = d.reshape(16, 128).min(1).values
            assert torch.equal(within[t], gap <= cutoff * (1 + 1e-5))


@pytest.mark.parametrize("n_out,L", [(1, 1), (2, 8192), (8, 1001),
                                     (2, 200_000), (8, 70_000)])
def test_workspace_holds_the_payload_and_its_flags(n_out, L):
    """A fused call's receive buffer holds its payload (the rows and the
    block ranges behind them) and has an arrival flag for each copy item
    of a row and one for the ranges, in a whole number of flags."""
    q, nb = 3 + n_out, -(-L // 128)
    cap = peer.workspace_cap(cuda_dma.workspace_floats(n_out, L))
    assert cap >= q * L + 2 * nb
    assert cap % peer.MIN_CHUNK_FLOATS == 0
    n_flags = q * -(-L // peer.CHUNK_FLOATS) + 1
    assert cap // peer.MIN_CHUNK_FLOATS >= n_flags


@pytest.mark.parametrize("n_items,n_blocks,want", [
    (384, 64, 11), (128, 9, 9), (3, 1, 1), (4096, 64, 1), (1, 1000, 1000),
    (1000, 64, 5)])
def test_halo_segments_fill_the_grid(n_items, n_blocks, want):
    """Each (shard, source, tile) is cut into enough segments that all of
    them make about HALO_ITEMS items, at most one a block of the rows."""
    n_seg = cuda_dma.halo_segments(n_items, n_blocks)
    assert n_seg == want
    assert 1 <= n_seg <= n_blocks


@pytest.mark.parametrize("n", FUSED_SHARDS)
def test_fused_lines_route_is_the_packed_route(jax_refs, n):
    """On the CPU the rows-apart route packs the rows and lays the shards'
    sums out as the grid's: equal to the packed wrapper's result; it
    counts one epoch, no launch, and refuses rows of unequal length."""
    nu, skl, _ = jax_refs["fused"][n]
    ring = peer.loopback_ring(n, "cpu")
    nu_t = torch.as_tensor(nu).reshape(n, -1)
    lines = KernelLines(*_torch_skl(skl))
    before = cuda_dma.HALO_LAUNCHES
    got = cuda_dma.fused_halo_accumulate_lines(ring, nu_t, lines,
                                               cutoff_cm1=CUTOFF)
    want = cuda_dma.fused_halo_accumulate_cuda(ring, nu_t,
                                               halo.pack_lines(lines),
                                               cutoff_cm1=CUTOFF)
    assert cuda_dma.HALO_LAUNCHES == before and ring.epoch == 2
    assert torch.equal(got, want.transpose(0, 1).reshape(2, -1))
    with pytest.raises(ValueError, match="scale_x must be"):
        cuda_dma.fused_halo_accumulate_lines(
            ring, nu_t, lines._replace(scale_x=lines.scale_x[:, 1:]))
    assert ring.epoch == 2


def test_workspace_keeps_the_ring_launch_arguments():
    """The ring kernel's arguments that do not change between calls are
    set once, when the workspace opens, in the kernel's own layout
    (csrc/dma_ring.cu RingArgs: 88 bytes, the fields in C order)."""
    import ctypes
    table = torch.arange(12, dtype=torch.int64).reshape(4, 3)
    ws = peer.PeerWorkspace(torch.device("cuda", 3), 1 << 16, [], [], table,
                            loopback=True)
    a = ws.ring_args
    assert (a.table, a.cap_floats, a.n_loc, a.device, a.loopback) == (
        table.data_ptr(), 1 << 16, 4, 3, 1)
    assert a.timeout_s == pytest.approx(peer.TIMEOUT_S)
    assert (a.x, a.out, a.n, a.epoch) == (None, None, 0, 0)
    R = peer.RingArgs
    assert ctypes.sizeof(R) == 88
    assert [getattr(R, f).offset for f in (
        "table", "x", "out", "n", "cap_floats", "epoch", "n_loc", "d",
        "chunk", "device", "loopback", "timeout_s", "stream", "n_dirs")] == [
        0, 8, 16, 24, 32, 40, 48, 52, 56, 60, 64, 68, 72, 80]
    ranks = peer.PeerWorkspace(torch.device("cuda", 0), 1 << 20, [], [],
                               table[:1], object(), loopback=False)
    assert (ranks.ring_args.n_loc, ranks.ring_args.loopback) == (1, 0)


@pytest.mark.parametrize("gloo", [2, 4], indirect=True)
def test_epoch_is_the_same_on_every_rank(gloo):
    # Two ring exchanges and one fused sum, plus two for the halo lines.
    want = 3 + (2 if len(gloo) == 4 else 0)
    assert [r["epoch"] for r in gloo] == [want] * len(gloo)


def test_two_shards_make_one_hop(jax_refs):
    """With two shards the neighbours coincide: one exchange, one halo sum
    (the left neighbour's), or the halo would count its lines twice."""
    assert [peer.loopback_ring(n, "cpu").directions
            for n in (1, 2, 3, 8)] == [(), (0,), (0, 1), (0, 1)]
    nu, skl, _ = jax_refs["fused"][2]
    ring = peer.loopback_ring(2, "cpu")
    nu_t = torch.as_tensor(nu).reshape(2, -1)
    packed = halo.pack_lines(KernelLines(*_torch_skl(skl)))
    got = cuda_dma.fused_halo_accumulate_cuda(ring, nu_t, packed,
                                              cutoff_cm1=CUTOFF)
    assert ring.epoch == 1               # one call, one exchange
    acc = lambda k, j: accumulate_plain(nu_t[k], halo.unpack_lines(
        packed[j]), cutoff_cm1=CUTOFF)
    for k in range(2):
        torch.testing.assert_close(got[k], acc(k, k) + acc(k, 1 - k),
                                   rtol=0.0, atol=0.0)


def test_peer_workspace_without_peer_access_raises(monkeypatch):
    """Ring neighbours on two cards must reach each other's memory: the
    check raises before anything is allocated; two shards on one card need
    no peer access."""
    seen = []

    def no_access(a, b):
        seen.append((a, b))
        return False

    monkeypatch.setattr(torch.cuda, "can_device_access_peer", no_access)
    with pytest.raises(RuntimeError, match="no peer access"):
        peer.check_peer_access([0, 1, 2, 3])
    assert seen == [(0, 1)]
    peer.check_peer_access([0, 0])
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: (a, b) != (3, 0))
    with pytest.raises(RuntimeError, match="cuda:3 and cuda:0"):
        peer.check_peer_access([0, 1, 2, 3])


def test_wrappers_reject_what_they_do_not_take():
    ring = peer.loopback_ring(4, "cpu")
    with pytest.raises(ValueError, match=r"\+1 or -1"):
        cuda_dma.ring_exchange_cuda(ring, torch.zeros(4, 2, 2), 2)
    with pytest.raises(ValueError, match=r"\[4, \.\.\.\]"):
        cuda_dma.ring_exchange_cuda(ring, torch.zeros(3, 2, 2), 1)
    with pytest.raises(ValueError, match="3 \\+ n_out"):
        cuda_dma.fused_halo_accumulate_cuda(ring, torch.zeros(4, 8),
                                            torch.zeros(4, 3, 8))
    with pytest.raises(ValueError, match="do not split"):
        dma_halo.fused_halo_accumulate_fn(ring)(
            torch.zeros(10), ShardedKernelLines(*(torch.zeros(4, 8),) * 3,
                                                torch.zeros(4, 2, 8)))
    with pytest.raises(ValueError, match="no peer workspace"):
        ring.workspace_for(16)
    assert ring.epoch == 0               # nothing was counted
