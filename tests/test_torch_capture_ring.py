"""The capture ring: the transport of a captured mesh body's nu-halo exchange
(``parallel.collectives.capture_exchange`` over ``Mesh.capture_ring``, the
port's ring kernel ``csrc/dma_ring.cu`` on the card), on the CPU:

- every mesh has one, over the ranks of its ``nu`` group;
- the exchange over it (its plain version here) is bit-equal to the eager
  exchange on the ``nu`` group and to ``ring_shift``, for messages of
  float64, int64 and float32 rows of a length that needs padding;
- only a capture takes it: the eager mesh bodies, their ``jacfwd``,
  ``ring_shift`` and the eager exchange never do, and an exchange issued
  with a stream while a capture is under way does (and is refused on
  another axis than ``nu``);
- the packing of the messages into the ring kernel's float32 row, and the
  host side of the kernel's directions and of a ring on the device's
  epoch.

The kernel's own side (two directions in one launch, the epoch counted on
the card across graph replays) runs on the card:
``tests/test_torch_cuda.py::test_captured_ring_exchange_counts_its_epoch_on_the_card``.
"""

import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
from spectrobot_tpu_torch.parallel import collectives as C
from spectrobot_tpu_torch.parallel import cuda_dma
from spectrobot_tpu_torch.parallel import peer

torch.set_num_threads(1)

WORLD = 4
SHAPES = [(1, 1, 4), (1, 2, 2)]


def _messages(world, L=40, seed=11):
    """Each rank's three messages: 8 float64 rows, 3 int64 rows and 2
    float32 rows of 37 (296 bytes: padded in the packed row)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((world, 8, L)),
            rng.integers(-5, 1000, (world, 3, L)),
            rng.standard_normal((world, 2, 37)).astype(np.float32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return cases.run(tmp_path_factory.mktemp("capture_ring"), WORLD,
                     cases.capture_ring_case, _messages(WORLD), SHAPES)


def _equal(a, b) -> bool:
    return (len(a) == len(b) and all(
        len(x) == len(y) and all(u.dtype == v.dtype and torch.equal(u, v)
                                 for u, v in zip(x, y))
        for x, y in zip(a, b)))


def test_every_mesh_has_a_capture_ring_over_its_nu_group(ranks):
    for out in ranks:
        for shape in SHAPES:
            ring = out["rings"][shape]
            assert ring["ranks"] == ring["nu_ranks"], shape
            assert len(ring["ranks"]) == ring["n"] == shape[2]
            assert ring["on_device"] and ring["mesh_is_its"]
            assert not ring["loopback"]


def test_captured_exchange_bit_equal_to_ring_shift_and_the_nu_group(ranks):
    """Each hop's messages, dtype and bits, as the eager exchange and
    ring_shift give them; no workspace opens on the CPU."""
    msgs = _messages(WORLD)
    for rank, out in enumerate(ranks):
        for shape in SHAPES:
            ex = out["exchange"][shape]
            assert ex["shifts"] == ([1, -1] if shape[2] > 2 else [1])
            assert _equal(ex["capture"], ex["eager"]), shape
            assert _equal(ex["capture"], ex["ring_shift"]), shape
            assert ex["workspace"] is None
            # The left neighbour's messages at shift 1.
            n = shape[2]
            left = rank - rank % n + (rank % n - 1) % n
            for m, got in zip(msgs, ex["capture"][0]):
                np.testing.assert_array_equal(got.numpy(), m[left])


def test_only_a_capture_takes_the_capture_ring(ranks):
    for out in ranks:
        assert out["eager"] == []
        calls, got, refused = out["captured"]
        assert calls == [(True, [1, -1], True)]
        assert _equal(got, out["exchange"][(1, 1, 4)]["eager"])
        assert refused


@pytest.mark.parametrize("dtype,shape", [
    (torch.float64, (8, 40)), (torch.int64, (3, 5)), (torch.float32, (2, 37)),
    (torch.int32, (1,)), (torch.float16, (3, 3))])
def test_packed_messages_round_trip(dtype, shape):
    """Each message's bytes on a 16-byte boundary of one float32 row, and
    its views back bit for bit, beside a float64 message."""
    g = torch.Generator().manual_seed(3)
    x = (torch.randint(-1000, 1000, shape, generator=g).to(dtype)
         if not dtype.is_floating_point
         else torch.randn(shape, generator=g).to(dtype))
    other = torch.randn(2, 3, dtype=torch.float64, generator=g)
    sends = [x, other]
    row = C.pack_messages(sends)
    nbytes = x.numel() * x.element_size()
    assert row.dtype == torch.float32 and row.shape == (
        1, C.packed_floats(sends))
    assert C.packed_floats(sends) * 4 == -(-nbytes // 16) * 16 + 48
    back = C.unpack_messages(row[0], sends)
    assert all(b.dtype == s.dtype and torch.equal(b, s)
               for b, s in zip(back, sends))


def test_ring_kernel_directions():
    """The kernel's (first direction, count): (+1,), (-1,) and (+1, -1),
    and nothing else."""
    assert cuda_dma._directions((1,)) == (0, 1)
    assert cuda_dma._directions((-1,)) == (1, 1)
    assert cuda_dma._directions([1, -1]) == (0, 2)
    for bad in ((-1, 1), (2,), (1, 1), ()):
        with pytest.raises(ValueError):
            cuda_dma._directions(bad)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_ring_exchange_hops_plain_is_each_roll(n):
    """Both directions in one call: [2, ...], each the roll of its
    direction, one call counted."""
    ring = peer.loopback_ring(n, "cpu")
    x = torch.arange(n * 6, dtype=torch.float32).reshape(n, 2, 3)
    got = cuda_dma.ring_exchange_hops(ring, x, (1, -1))
    assert got.shape == (2, n, 2, 3) and ring.epoch == 1
    assert torch.equal(got[0], torch.roll(x, 1, 0))
    assert torch.equal(got[1], torch.roll(x, -1, 0))
    assert torch.equal(cuda_dma.ring_exchange_cuda(ring, x, -1),
                       torch.roll(x, -1, 0))


def test_ring_on_the_devices_epoch_on_the_cpu():
    """A ring on the device's epoch opens no workspace on the CPU: reserve
    does nothing, it is never reserved and its device count reads 0."""
    ring = peer.Ring(4, "cpu", on_device=True)
    ring.reserve(1 << 20)
    assert ring.workspace is None and not ring.reserved(1)
    assert ring.device_calls() == 0 and ring.ranks is None
    assert not peer.loopback_ring(4, "cpu").on_device
