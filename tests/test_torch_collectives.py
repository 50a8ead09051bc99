"""The port's differentiable collectives (spectrobot_tpu_torch/parallel/
collectives.py) in gloo ranks: torch.func.jacfwd, the vjp and
torch.func.vmap through a psum over (ray, nu), a ring shift over nu and an
all_gather over ray equal the single-process result of the same function,
at world sizes 2 (mesh (1, 1, 2)) and 4 (mesh (2, 1, 2))."""

import numpy as np
import pytest
import torch

import torch_mesh_cases as cases

torch.set_num_threads(1)

SHAPES = {2: (1, 1, 2), 4: (2, 1, 2)}


def _inputs(world, seed=0):
    rng = np.random.default_rng(seed)
    n_out = 3 + 3 + 3 * SHAPES[world][0]
    return (rng.standard_normal((world, 3, 5)), rng.standard_normal(5),
            rng.standard_normal((world, n_out)),
            rng.standard_normal((4, 5)))


def emulated(xs, A, shape, rank):
    """What rank ``rank`` of the mesh computes (``cases.collective_fn``),
    in one process: ``xs`` holds every rank's copy of the input."""
    n_ray, _, n_nu = shape
    ls = [torch.sin(A[k] @ xs[k]) for k in range(len(xs))]
    s = sum(l * l for l in ls)
    ray, nu = divmod(rank, n_nu)
    sh = ls[ray * n_nu + (nu - 1) % n_nu]
    g = torch.cat([ls[i * n_nu + nu] for i in range(n_ray)])
    return torch.cat([s, sh * s, g])


@pytest.fixture(scope="module", params=sorted(SHAPES))
def ranks(request, tmp_path_factory):
    world = request.param
    A, x, ct, xs = _inputs(world)
    got = cases.run(tmp_path_factory.mktemp(f"coll{world}"), world,
                    cases.collectives_case, SHAPES[world], A, x, ct, xs)
    return world, tuple(torch.as_tensor(a) for a in (A, x, ct, xs)), got


def test_value_and_jacfwd(ranks):
    world, (A, x, _, _), got = ranks
    for r in range(world):
        f = lambda v: emulated([v] * world, A, SHAPES[world], r)
        torch.testing.assert_close(got[r]["value"], f(x), rtol=1e-14,
                                   atol=1e-14)
        torch.testing.assert_close(got[r]["jacfwd"],
                                   torch.func.jacfwd(f)(x), rtol=1e-12,
                                   atol=1e-14)


def test_vjp(ranks):
    """Each rank's gradient of sum_r <ct_r, f_r> with respect to its own
    copy of x: the transposed collectives carry every rank's cotangent."""
    world, (A, x, ct, _), got = ranks
    xs = [x.clone().requires_grad_() for _ in range(world)]
    total = sum(torch.sum(ct[r] * emulated(xs, A, SHAPES[world], r))
                for r in range(world))
    ref = torch.autograd.grad(total, xs)
    for r in range(world):
        torch.testing.assert_close(got[r]["vjp"], ref[r], rtol=1e-12,
                                   atol=1e-14)


def test_vmap(ranks):
    world, (A, _, _, xs), got = ranks
    for r in range(world):
        ref = torch.stack([emulated([v] * world, A, SHAPES[world], r)
                           for v in xs])
        torch.testing.assert_close(got[r]["vmap"], ref, rtol=1e-14,
                                   atol=1e-14)


def test_ring_shift_round_trip(ranks):
    """A shift by +1 then by -1 gives every rank its own tensor back, also
    with two ranks on the ring (where both neighbours are one rank)."""
    world, (_, x, _, _), got = ranks
    for r in range(world):
        nu = r % SHAPES[world][2]
        torch.testing.assert_close(got[r]["shift_twice"], x * (1 + nu),
                                   rtol=0, atol=0)
