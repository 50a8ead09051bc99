"""The peer workspace of a 1-D ``nu`` ring: what the remote-copy tier
(``ops/cuda_dma.py``, ``dma_halo.py``) needs in place of the remote refs
and DMA semaphores that Pallas gives the reference's TPU kernels
(``benchmarks/dma_halo.py``).

A :class:`Ring` is either

- the ranks of a mesh's ``nu`` axis (:func:`mesh_ring`), one shard per rank
  and card.  Each rank allocates its workspace with ``cudaMalloc`` (its own
  allocation: an IPC handle maps the whole allocation that holds a
  pointer), exchanges its 64-byte CUDA IPC handle through the axis's
  process group and maps its two ring neighbours' workspaces
  (``cudaIpcOpenMemHandle`` with ``cudaIpcMemLazyEnablePeerAccess``).
  Neighbours on two cards must have peer access, or opening raises;
- or the loopback (:func:`loopback_ring`): ``n`` virtual shards held in
  this process on one device, whose peer pointers are plain local
  pointers; one kernel launch covers all of them.  The counterpart of the
  reference's emulated CPU mesh: a test vehicle, never a fallback.

A workspace (layout in ``csrc/peer_ring.cuh``) holds two receive buffers
(rows from the left and from the right neighbour), one "destination free"
flag per direction and one arrival flag per chunk and direction.  The host
side of the protocol lives here: the epoch, counted up once per call and
the same on every rank, which every flag of the call is waited up to (so
no flag is ever reset), the size of a call's copy items
(:func:`ring_chunk`), and the ring kernel's launch arguments, kept on the
workspace between calls (:class:`RingArgs`).  On the CPU a ring has no
workspace (the wrappers run their plain versions), but counts its calls
alike.

A ring ``on_device`` counts its epochs on the card instead: a CUDA graph
freezes a launch's arguments, so each ring kernel launch on it takes its
epoch from a count in its workspace and advances it
(:meth:`Ring.device_calls` reads it back).  Each mesh has one such ring on
its ``nu`` axis, its capture ring (``parallel.mesh.Mesh.capture_ring``),
which carries the exchange of every captured mesh body
(``parallel.collectives.ring_exchange_start``).  Every workspace opened is
kept in the order it opened, the same on every rank, until
:func:`close_rings` (``parallel.mesh.finalize_multihost``).
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# Floats per copy item of the kernels: at most CHUNK_FLOATS (32 KB), at
# least MIN_CHUNK_FLOATS (4 KB: one 16-byte load for each of a block's 256
# threads; csrc/peer_ring.cuh MIN_CHUNK, checked when the library is
# loaded).  A ring call cuts its block into about RING_ITEMS items (two for
# each of the H100's 132 SMs) within those limits; the fused halo kernel's
# items are CHUNK_FLOATS.
CHUNK_FLOATS = 8192
MIN_CHUNK_FLOATS = 1024
RING_ITEMS = 264
# A spin on a peer's flag traps after this long, counted from the start of
# the wait: a lost peer ends in a CUDA error instead of a hang.  So the
# ranks of a ring launch in step: each rank's launch starts within
# TIMEOUT_S of its neighbours'.  The first launch on a workspace follows the
# barrier that opens it, and each kernel library's first use a barrier too
# (Ring.sync_once); host work between calls that skews the ranks by more
# than this (a rank writing files, a long kernel queued ahead) traps the
# waiting kernel and loses its process's CUDA context.
TIMEOUT_S = 5.0

_LIB = None
_MESH_RINGS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# The rings whose workspace is open, in the order they opened.
_OPEN: list = []


class RingArgs(ctypes.Structure):
    """The ring kernel's launch arguments (``csrc/dma_ring.cu`` RingArgs,
    the same layout, checked when the library is loaded).  A workspace
    keeps one and the wrapper sets the fields that change between calls
    (x, out, n, d, n_dirs, chunk, epoch, stream; epoch 0: the device
    counts it)."""
    _fields_ = [("table", ctypes.c_void_p), ("x", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("cap_floats", ctypes.c_longlong),
                ("epoch", ctypes.c_ulonglong), ("n_loc", ctypes.c_int),
                ("d", ctypes.c_int), ("chunk", ctypes.c_int),
                ("device", ctypes.c_int), ("loopback", ctypes.c_int),
                ("timeout_s", ctypes.c_float), ("stream", ctypes.c_void_p),
                ("n_dirs", ctypes.c_int)]


def library() -> ctypes.CDLL:
    """The library of ``csrc/dma_ring.cu`` (the ring kernel and the
    workspace's functions), built and bound on first use."""
    global _LIB
    if _LIB is None:
        from spectrobot_tpu_torch.kernels import build

        lib = build.load("dma_ring")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name, args in (("dma_ws_alloc", [i32, i64, ptr]),
                           ("dma_ws_free", [i32, ptr]),
                           ("dma_ipc_get", [i32, ptr, ptr]),
                           ("dma_ipc_open", [i32, ptr, ptr]),
                           ("dma_ipc_close", [i32, ptr]),
                           ("dma_ring_launch", [ctypes.POINTER(RingArgs)]),
                           ("dma_ws_calls", [i32, ptr,
                                             ctypes.POINTER(
                                                 ctypes.c_ulonglong)])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, i32
        lib.dma_ws_bytes.argtypes, lib.dma_ws_bytes.restype = [i64], i64
        lib.dma_ring_error_string.argtypes = [i32]
        lib.dma_ring_error_string.restype = ctypes.c_char_p
        layout = (lib.dma_ring_args_bytes(), lib.dma_min_chunk())
        if layout != (ctypes.sizeof(RingArgs), MIN_CHUNK_FLOATS):
            raise RuntimeError(f"ring kernel's argument bytes and least "
                               f"chunk {layout} != the host's "
                               f"{(ctypes.sizeof(RingArgs), MIN_CHUNK_FLOATS)}")
        _LIB = lib
    return _LIB


def ring_chunk(n_floats: int, n_loc: int) -> int:
    """Floats per copy item of a ring call of ``n_loc`` blocks of
    ``n_floats``: a multiple of ``MIN_CHUNK_FLOATS`` within
    [MIN_CHUNK_FLOATS, CHUNK_FLOATS], near the size that makes
    ``RING_ITEMS`` items."""
    per = -(-n_floats * n_loc // RING_ITEMS)
    per = -(-per // MIN_CHUNK_FLOATS) * MIN_CHUNK_FLOATS
    return min(CHUNK_FLOATS, max(MIN_CHUNK_FLOATS, per))


def workspace_cap(n_floats: int) -> int:
    """Floats of each receive buffer of a workspace opened for
    ``n_floats``: at least 64 K, a multiple of 4096 (so of
    ``MIN_CHUNK_FLOATS``: a whole number of arrival flags)."""
    return -(-max(int(n_floats), 1 << 16) // 4096) * 4096


def _call(name: str, *args) -> None:
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc} "
                           f"({lib.dma_ring_error_string(rc).decode()})")


def check_peer_access(devices: Sequence[int]) -> None:
    """Raise unless each pair of ring neighbours among the cards
    ``devices`` (in ring order) can reach each other's memory.  Two shards
    on one card need nothing."""
    n = len(devices)
    for k in range(n):
        a, b = devices[k], devices[(k + 1) % n]
        for src, dst in ((a, b), (b, a)):
            if src != dst and not torch.cuda.can_device_access_peer(src, dst):
                raise RuntimeError(
                    f"ring neighbours on cuda:{src} and cuda:{dst} have no "
                    f"peer access: the remote-copy tier needs every card of "
                    f"the nu ring to reach its neighbours' memory (NVLink "
                    f"or PCIe peer-to-peer)")


class PeerWorkspace:
    """The device side of a ring: workspaces of ``cap_floats`` floats per
    receive buffer, ``table`` [n_loc, 3] (int64, on the device) with the
    bases of each local shard's own, left and right workspaces, and the
    ring kernel's launch arguments that do not change between calls
    (``ring_args``; ``loopback``: every shard in this process)."""

    def __init__(self, device: torch.device, cap_floats: int, owned: list,
                 mapped: list, table: torch.Tensor, group=None, *,
                 loopback: bool):
        self.device, self.cap_floats = device, cap_floats
        self.owned, self.mapped, self.table = owned, mapped, table
        self.group = group
        self.ring_args = RingArgs(
            table=table.data_ptr(), cap_floats=cap_floats,
            n_loc=table.shape[0], device=device.index,
            loopback=int(loopback), timeout_s=TIMEOUT_S)

    def close(self) -> None:
        """Unmap the neighbours' workspaces and free this process's own (on
        a ring of ranks every rank calls it: the frees wait until no rank
        maps them)."""
        if self.table is None:
            return
        idx = self.device.index
        torch.cuda.synchronize(self.device)
        if self.group is not None:
            dist.barrier(group=self.group)
        for p in self.mapped:
            _call("dma_ipc_close", idx, ctypes.c_void_p(p))
        if self.group is not None:
            dist.barrier(group=self.group)
        for p in self.owned:
            _call("dma_ws_free", idx, ctypes.c_void_p(p))
        self.owned, self.mapped, self.table = [], [], None


def _alloc(idx: int, cap_floats: int) -> int:
    p = ctypes.c_void_p()
    _call("dma_ws_alloc", idx, library().dma_ws_bytes(cap_floats),
          ctypes.byref(p))
    return int(p.value)


def _table(rows, device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.int64, device=device)


def _open_loopback(n: int, device: torch.device,
                   cap_floats: int) -> PeerWorkspace:
    with torch.cuda.device(device):
        owned = [_alloc(device.index, cap_floats) for _ in range(n)]
    rows = [[owned[k], owned[(k - 1) % n], owned[(k + 1) % n]]
            for k in range(n)]
    return PeerWorkspace(device, cap_floats, owned, [], _table(rows, device),
                         loopback=True)


def _open_ranks(mesh, device: torch.device,
                cap_floats: int) -> PeerWorkspace:
    """Collective over the mesh's ``nu`` group: every rank of it calls."""
    group = mesh.groups["nu"]
    n, k = mesh.shape["nu"], mesh.coord["nu"]
    idx = device.index
    devices = [None] * n
    dist.all_gather_object(devices, idx, group=group)
    check_peer_access(devices)
    lib = library()
    with torch.cuda.device(device):
        own = _alloc(idx, cap_floats)
        handle = ctypes.create_string_buffer(lib.dma_ipc_handle_bytes())
        _call("dma_ipc_get", idx, ctypes.c_void_p(own),
              ctypes.cast(handle, ctypes.c_void_p))
        handles = [None] * n
        dist.all_gather_object(handles, handle.raw, group=group)
        peers, mapped = {k: own}, []
        for j in ((k - 1) % n, (k + 1) % n):
            if j not in peers:
                p = ctypes.c_void_p()
                buf = ctypes.create_string_buffer(handles[j],
                                                  len(handles[j]))
                _call("dma_ipc_open", idx, ctypes.cast(buf, ctypes.c_void_p),
                      ctypes.byref(p))
                peers[j] = int(p.value)
                mapped.append(peers[j])
    dist.barrier(group=group)
    rows = [[own, peers[(k - 1) % n], peers[(k + 1) % n]]]
    return PeerWorkspace(device, cap_floats, [own], mapped,
                         _table(rows, device), group, loopback=False)


class Ring:
    """A 1-D ``nu`` ring of ``n`` shards on ``device``: the ranks of
    ``mesh``'s ``nu`` axis, or (``mesh`` None) the loopback of ``n`` shards
    in this process.  Holds the epoch (calls made) and, on a card, the
    peer workspace, grown on demand.  ``on_device``: the ring kernel's
    launches count their epochs on the card (the module docstring), and
    the fused kernel, which takes its epoch from the host, refuses the
    ring."""

    def __init__(self, n: int, device, mesh=None, *, on_device: bool = False):
        self.n, self.mesh = int(n), mesh
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.on_device = on_device
        self.epoch = 0
        self.workspace: Optional[PeerWorkspace] = None
        self._synced: set = set()

    @property
    def ranks(self) -> list:
        """The global ranks of a ring of ranks, in ring order (the ranks of
        the mesh's ``nu`` group); None on the loopback."""
        if self.mesh is None:
            return None
        return dist.get_process_group_ranks(self.mesh.groups["nu"])

    @property
    def loopback(self) -> bool:
        return self.mesh is None

    @property
    def local_shards(self) -> int:
        """The shards one launch covers: all on the loopback, else one."""
        return self.n if self.loopback else 1

    @property
    def directions(self) -> tuple:
        """The directions of a halo call, the reference's static ring
        degeneracies: none with one shard; with two only rightward (the
        neighbours coincide, and two hops would count them twice)."""
        return () if self.n == 1 else (0,) if self.n == 2 else (0, 1)

    def begin_call(self) -> int:
        """Count one call on this ring and return its epoch: the value every
        flag of the call (each receiver's "destination free", each chunk's
        arrival) is set to and waited for."""
        self.epoch += 1
        return self.epoch

    def sync_once(self, key: str) -> None:
        """On a ring of ranks, a barrier the first time ``key`` is named:
        after a kernel library is loaded, so that no rank starts waiting on
        a peer that is still compiling."""
        if key not in self._synced:
            if self.mesh is not None:
                dist.barrier(group=self.mesh.groups["nu"])
            self._synced.add(key)

    def workspace_for(self, n_floats: int) -> PeerWorkspace:
        """The workspace, reopened larger if a receive buffer holds fewer
        than ``n_floats`` floats (on a ring of ranks, every rank asks for the
        same size in the same call)."""
        if self.device.type != "cuda":
            raise ValueError(f"a ring on {self.device} has no peer workspace")
        ws = self.workspace
        if ws is None or ws.cap_floats < n_floats:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"a ring's workspace opens outside a CUDA graph's "
                    f"capture: reserve({n_floats}) it first")
            cap = workspace_cap(n_floats)
            if ws is not None:
                self.close()
            self.workspace = (_open_loopback(self.n, self.device, cap)
                              if self.loopback else
                              _open_ranks(self.mesh, self.device, cap))
            _OPEN.append(self)
        return self.workspace

    def reserve(self, n_floats: int) -> None:
        """Ready the ring, outside any capture, for ring kernel calls of
        ``n_floats`` floats a shard: its library loaded, the first-use
        barrier made and the workspace open and large enough (on a ring of
        ranks, collective: every rank asks for the same size in the same
        call).  Growing the workspace of a ring ``on_device`` drops every
        captured mesh graph first (``parallel.graphed.release_graphs``:
        they hold the old workspace), and its count of calls starts anew
        with the new workspace, on every rank alike.  Nothing on the
        CPU."""
        if self.device.type != "cuda":
            return
        library()
        self.sync_once("dma_ring")
        ws = self.workspace
        if self.on_device and ws is not None and ws.cap_floats < n_floats:
            from spectrobot_tpu_torch.parallel.graphed import release_graphs
            release_graphs()
        self.workspace_for(n_floats)

    def reserved(self, n_floats: int) -> bool:
        """Whether :meth:`reserve` has readied the ring for calls of
        ``n_floats`` floats a shard."""
        ws = self.workspace
        return (ws is not None and ws.cap_floats >= n_floats
                and "dma_ring" in self._synced)

    def device_calls(self) -> int:
        """The ring kernel's count of calls on the card (the epoch of its
        last call on a ring ``on_device``), read back from the workspace
        of this process's first shard (a synchronising copy); 0 before the
        workspace opens."""
        if self.workspace is None:
            return 0
        out = ctypes.c_ulonglong()
        _call("dma_ws_calls", self.device.index,
              ctypes.c_void_p(self.workspace.owned[0]), ctypes.byref(out))
        return int(out.value)

    def close(self) -> None:
        if self.workspace is not None:
            self.workspace.close()
            self.workspace = None
            _OPEN.remove(self)


def close_rings() -> None:
    """Close every open ring's workspace, in the order they opened (on a
    ring of ranks collective, and the order is the same on every rank)."""
    for ring in list(_OPEN):
        ring.close()


def loopback_ring(n: int, device="cuda") -> Ring:
    """``n`` virtual shards of a ``nu`` ring in this process on ``device``."""
    if n < 1:
        raise ValueError(f"a ring has at least one shard, got {n}")
    return Ring(n, device)


def mesh_ring(mesh, device=None) -> Ring:
    """The ring of ``mesh``'s ``nu`` axis on ``device`` (default the mesh's),
    one per mesh and shared by every function built on it.  Needs a mesh
    over ``nu`` alone.  A CUDA ring on a gloo mesh keeps the host's
    handshakes off NCCL."""
    if mesh.shape["ray"] * mesh.shape["line"] != 1:
        raise ValueError(f"the remote-copy tier runs on a 1-D nu mesh, got "
                         f"{mesh.shape}")
    if mesh not in _MESH_RINGS:
        _MESH_RINGS[mesh] = Ring(mesh.shape["nu"], device or mesh.device,
                                 mesh)
    return _MESH_RINGS[mesh]
