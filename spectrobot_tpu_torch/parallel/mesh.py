"""The (ray, line, nu) process mesh (port of ``spectrobot_tpu.parallel.mesh``).

Three named axes over the ranks of a ``torch.distributed`` world:

    ray  -- data parallelism over tangent heights / nadir pixels
    line -- line-list sharding, partial depths summed by one all-reduce
    nu   -- the fine wavenumber grid cut into contiguous chunks

``nu`` is the innermost axis, so neighbouring ranks (one host, NVLink)
carry its halo and all-reduce traffic.  Every rank runs the same program on
its own block (SPMD): :meth:`Mesh.block` says which block of a sharded axis
is this rank's, and the collectives of :mod:`.collectives` run over one
axis's process group.

Backends: NCCL for CUDA (one card per rank, ``cuda:LOCAL_RANK``), gloo for
the CPU.  :func:`initialize_multihost` joins the world that ``torchrun``
describes in its environment, or makes an in-process world of size 1.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from spectrobot_tpu_torch.parallel.graphed import release_graphs
from spectrobot_tpu_torch.parallel.peer import Ring, close_rings

AXES = ("ray", "line", "nu")

# torchrun's environment: world size, this rank, the rendezvous address.
_TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_multihost(device_type: str) -> bool:
    """Join this run's process group, once per process, before any mesh.

    Under ``torchrun`` (its environment sets WORLD_SIZE, RANK, MASTER_ADDR
    and MASTER_PORT) the group spans every rank it started; a CUDA rank
    takes the card ``cuda:LOCAL_RANK``.  Without that environment the world
    is this process alone (size 1, a free localhost port).  Backend: NCCL
    for ``device_type='cuda'``, gloo for ``'cpu'``.

    Returns True when this call made the group (its caller ends it with
    :func:`finalize_multihost`), False when one existed.
    """
    if dist.is_initialized():
        return False
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device type "
                         f"{device_type!r} (cuda or cpu)")
    if all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0)
    return True


def finalize_multihost() -> None:
    """End this run's process group, after dropping every captured mesh
    graph (``parallel.graphed.release_graphs``: a graph holds NCCL's
    kernels, and NCCL's teardown waits for such graphs to go) and closing
    every open peer ring (``parallel.peer.close_rings``: the meshes'
    capture rings among them), whose handshakes run over the group."""
    release_graphs()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    close_rings()
    dist.destroy_process_group()


class Mesh:
    """This rank's view of the (ray, line, nu) mesh: ``shape`` and ``coord``
    map each axis name to its size and to this rank's index along it;
    ``groups`` to the process group of the ranks that differ from this one
    only along that axis.

    ``capture_ring``: the ring of this rank's ``nu`` group
    (``parallel.peer.Ring``, its epochs counted on the card) that carries
    the exchange of a captured mesh body
    (``collectives.ring_exchange_start``): NCCL keeps every eager call,
    the captured exchange leaves it.  Its workspace opens when an eager
    exchange on the card first needs it (a handshake over the ``nu``
    group) and closes in :func:`finalize_multihost`."""

    def __init__(self, device_mesh):
        self.device_type = device_mesh.device_type
        self.shape = dict(zip(AXES, device_mesh.shape))
        self.coord = {ax: device_mesh.get_local_rank(ax) for ax in AXES}
        self.groups = {ax: device_mesh.get_group(ax) for ax in AXES}
        self.capture_ring = Ring(self.shape["nu"], self.device, self,
                                 on_device=True)

    @property
    def size(self) -> int:
        return self.shape["ray"] * self.shape["line"] * self.shape["nu"]

    @property
    def device(self) -> torch.device:
        """This rank's device: its card, or the CPU."""
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)

    def block(self, n: int, axis: str) -> slice:
        """This rank's block of an ``n``-long dimension sharded over
        ``axis`` in equal contiguous blocks (``n`` must divide)."""
        k = self.shape[axis]
        if n % k != 0:
            raise ValueError(f"{n} does not split into {k} equal blocks over "
                             f"the mesh axis {axis!r}")
        m = n // k
        return slice(self.coord[axis] * m, (self.coord[axis] + 1) * m)


def make_mesh(shape: Optional[Tuple[int, int, int]] = None,
              device_type: str = "cuda") -> Mesh:
    """The (ray, line, nu) mesh over the ranks of the current process group
    (:func:`initialize_multihost` first).  ``shape`` defaults to every rank
    on ``nu``; its product must equal the world size."""
    n = dist.get_world_size()
    shape = (1, 1, n) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != 3:
        raise ValueError(f"a mesh shape has 3 axes {AXES}, got {shape}")
    if shape[0] * shape[1] * shape[2] != n:
        raise ValueError(f"mesh shape (ray, line, nu) = {shape} needs "
                         f"{shape[0] * shape[1] * shape[2]} ranks, but the "
                         f"world has {n}")
    return Mesh(init_device_mesh(device_type, shape, mesh_dim_names=AXES))
