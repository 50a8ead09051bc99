"""Wavenumber-domain decomposition with a wing halo exchange (port of
``spectrobot_tpu.parallel.halo``).

The fine grid is cut over the mesh's ``nu`` axis; every line is OWNED by the
shard whose grid interval holds its center (a host-side partition of the
sorted list).  A line within ``cutoff`` of a shard boundary also reaches the
neighbouring shard, so each shard receives its two ring neighbours' line
parameters by ring shifts and sums its own and their lines on its chunk
with the usual |dnu| <= cutoff mask.  Exact when the cutoff is at most one
chunk wide (:func:`nu_shard_edges` checks).  The shifts of every hop are
issued before the shard's own line sum and waited on after it
(:func:`.collectives.ring_exchange_start`), so the exchange overlaps the
local accumulation, as XLA schedules the reference's permutes; the K3
accumulation on the card replays as one CUDA graph in which the exchange
is a branch beside the own sum (:mod:`.graphed`).

Every rank runs the same program on its own block: the functions built
here take the rank's grid chunk and its own row of a
:class:`ShardedKernelLines` (:func:`shard_lines`) and return its
[n_out, P_loc] block of the result.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from spectrobot_tpu_torch.ops.cuda_opacity import line_windows
from spectrobot_tpu_torch.ops.cuda_single import accumulate_single
from spectrobot_tpu_torch.ops.opacity import KernelLines, accumulate_plain
from spectrobot_tpu_torch.parallel.collectives import (
    OWN_SUM_RANGE, ring_exchange_start)
from spectrobot_tpu_torch.parallel.graphed import GraphedBody
from spectrobot_tpu_torch.utils.profiling import annotate


class ShardedKernelLines(NamedTuple):
    """Stage-2 kernel inputs partitioned by line OWNER shard: a leading
    shard axis [n_shards, Lmax]; slots beyond a shard's real line count are
    zero-amplitude pads (center 1e9, sx = y = 1e6)."""
    nu_c: torch.Tensor     # [n_shards, Lmax]
    scale_x: torch.Tensor  # [n_shards, Lmax]
    y: torch.Tensor        # [n_shards, Lmax]
    amps: torch.Tensor     # [n_shards, n_out, Lmax]


def shard_lines(skl: ShardedKernelLines, k: int) -> KernelLines:
    """The lines shard ``k`` owns, as one state's ``KernelLines``."""
    return KernelLines(skl.nu_c[k], skl.scale_x[k], skl.y[k], skl.amps[k])


def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def partition_kernel_lines(kl: KernelLines, nu0_host, edges: np.ndarray,
                           round_to: int = 128,
                           origins: Optional[np.ndarray] = None,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> ShardedKernelLines:
    """Host side: give each line to the shard whose [edges[k], edges[k+1])
    interval holds its (unshifted) center ``nu0_host`` (ascending) and pad
    the shards to a common Lmax, a multiple of ``round_to``.  Lines below
    the first or above the last edge belong to the first or last shard.

    ``origins`` ([n_shards]): per-shard wavenumber origins; each shard's
    centers are stored relative to its own, subtracted in float64 before
    any cast (pair with :func:`rebase_grid_per_shard`).  ``out_dtype``:
    the dtype of the result (default ``kl``'s); it lives on ``kl``'s
    device."""
    nu0_host = _host64(nu0_host)
    n_shards = len(edges) - 1
    cuts = np.concatenate([[0], np.searchsorted(nu0_host, edges[1:-1]),
                           [len(nu0_host)]])
    Lmax = max(int(np.diff(cuts).max()), 1)
    Lmax = ((Lmax + round_to - 1) // round_to) * round_to
    dtype = kl.amps.dtype if out_dtype is None else out_dtype

    def pack(a, fill, shift=None):
        a = _host64(a)
        out = np.full(a.shape[:-1] + (n_shards, Lmax), fill)
        for k in range(n_shards):
            seg = a[..., cuts[k]:cuts[k + 1]]
            if shift is not None:
                seg = seg - shift[k]
            out[..., k, :seg.shape[-1]] = seg
        return torch.as_tensor(out, dtype=dtype, device=kl.amps.device)

    return ShardedKernelLines(
        nu_c=pack(kl.nu_c, 1e9, shift=origins),
        scale_x=pack(kl.scale_x, 1e6), y=pack(kl.y, 1e6),
        amps=pack(kl.amps, 0.0).movedim(-2, 0))


def nu_shard_origins(edges: np.ndarray) -> np.ndarray:
    """Per-shard float32 wavenumber origins: the midpoint of each shard's
    interval, rounded to 0.25 cm^-1 (exactly representable), so origin
    deltas between neighbours are exact in float32."""
    mid = 0.5 * (edges[:-1] + edges[1:])
    return np.round(mid * 4.0) / 4.0


def rebase_grid_per_shard(nu_host, origins: np.ndarray,
                          dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """The fine grid with per-shard origins: chunk k holds nu - origins[k],
    subtracted in float64, then cast.  Meaningful only with line centers
    from ``partition_kernel_lines(..., origins=...)``."""
    nu_host = _host64(nu_host)
    n_shards = len(origins)
    if len(nu_host) % n_shards != 0:
        raise ValueError(f"{len(nu_host)} grid points do not split into "
                         f"{n_shards} shards")
    chunks = nu_host.reshape(n_shards, -1) - np.asarray(origins)[:, None]
    return torch.as_tensor(chunks.reshape(-1), dtype=dtype)


def pack_lines(kl: KernelLines) -> torch.Tensor:
    """Lines as one block of rows [nu_c, scale_x, y, amps_0..] x L (with a
    leading shard axis: [n, 3 + n_out, L])."""
    return torch.cat([torch.stack(tuple(kl[:3]), dim=-2), kl.amps], dim=-2)


def unpack_lines(packed: torch.Tensor) -> KernelLines:
    """The inverse of :func:`pack_lines`."""
    return KernelLines(packed[..., 0, :], packed[..., 1, :],
                       packed[..., 2, :], packed[..., 3:, :])


def _start_halo(lines: KernelLines, mesh, n_shards: int, stream=None):
    """Issue the halo's ring shifts of this shard's ``KernelLines``, one
    message each (the rows of :func:`pack_lines`; from ``stream``, as
    ``ring_exchange_start`` takes it); ``wait()`` gives, for each hop of
    :func:`_hops`, the neighbour's packed rows."""
    rows = [lines.nu_c, lines.scale_x, lines.y, *lines.amps]
    return ring_exchange_start([rows], mesh, "nu",
                               [shift for shift, _ in _hops(n_shards)],
                               stream=stream)


def _hops(n_shards: int):
    """The ring shifts of the halo, with the index of the window table of
    the lines each brings (1: the left neighbour's, 2: the right one's).
    With exactly two shards the neighbours coincide: one hop, or the halo
    counts their lines twice."""
    if n_shards == 1:
        return ()
    return ((1, 1),) if n_shards == 2 else ((1, 1), (-1, 2))


def halo_accumulate_fn(mesh, *, chunk: int = 256,
                       variant: str = "humlicek4",
                       cutoff_cm1: Optional[float] = 25.0,
                       origins: Optional[np.ndarray] = None):
    """Build f(nu_loc, mine) -> [n_out, P_loc] over the mesh's ``nu`` axis
    with the neighbour halo exchange, the line sum in plain PyTorch
    (``ops.opacity.accumulate_plain``, any dtype, Re w by the ``variant``
    evaluator).  ``nu_loc``: this rank's
    grid chunk; ``mine``: the lines it owns (:func:`shard_lines`).

    With ``origins``, the grid and the centers are shard-local coordinates
    (:func:`rebase_grid_per_shard`, ``partition_kernel_lines(origins=...)``);
    a received center is moved by the known origin delta of its sender,
    exact in float32 since the origins are multiples of 0.25 cm^-1."""
    n_shards, k = mesh.shape["nu"], mesh.coord["nu"]
    o = (np.zeros(n_shards) if origins is None
         else np.asarray(origins, np.float64))
    # A line from shard s, relative to o[s], needs + (o[s] - o[k]).
    delta = {1: o[(k - 1) % n_shards] - o[k], 2: o[(k + 1) % n_shards] - o[k]}

    def acc(nu_loc, kl):
        return accumulate_plain(nu_loc, kl, chunk=chunk,
                                cutoff_cm1=cutoff_cm1, variant=variant)

    def apply(nu_loc: torch.Tensor, mine: KernelLines) -> torch.Tensor:
        pending = _start_halo(mine, mesh, n_shards)
        with annotate(OWN_SUM_RANGE):
            out = acc(nu_loc, mine)
        for (_, src), (rows,) in zip(_hops(n_shards), pending.wait()):
            got = unpack_lines(rows)
            d = torch.as_tensor(delta[src], dtype=got.nu_c.dtype,
                                device=got.nu_c.device)
            out = out + acc(nu_loc, got._replace(nu_c=got.nu_c + d))
        return out

    return apply


def halo_accumulate_pallas_fn(mesh, nu_host, skl_nu0, *,
                              cutoff_cm1: Optional[float] = 25.0):
    """The halo accumulation with K3 (``ops.cuda_single.accumulate_single``)
    as each shard's line sum, in float32: the production multi-card path.
    Returns f(nu_loc, mine) -> [n_out, P_loc] as :func:`halo_accumulate_fn`.

    ``nu_host``: the full fine grid [P] (host, ascending); ``skl_nu0``: the
    per-shard padded centers [n_shards, Lmax] (``ShardedKernelLines.nu_c``).
    This rank's window tables against its own lines and against each ring
    neighbour's (which arrive by the ring shift) are built here, on the
    host, once.  On constant inputs on the card the body runs as one CUDA
    graph per input key, the exchange a branch beside the own K3 sum
    (``parallel.graphed.GraphedBody``; its ``body`` is the eager body).
    """
    n_shards, k = mesh.shape["nu"], mesh.coord["nu"]
    nu_host, skl_nu0 = _host64(nu_host), _host64(skl_nu0)
    P = len(nu_host)
    if P % n_shards != 0:
        raise ValueError(f"{P} grid points do not split into {n_shards} "
                         f"nu shards")
    grid_k = nu_host[mesh.block(P, "nu")]
    sources = (k, (k - 1) % n_shards, (k + 1) % n_shards)
    windows = {s_i: line_windows(grid_k, skl_nu0[sources[s_i]],
                                 cutoff_cm1=cutoff_cm1, device=mesh.device)
               for s_i in (0,) + tuple(s for _, s in _hops(n_shards))}

    def acc(nu_loc, kl, s_i):
        f32 = lambda a: a.to(torch.float32).contiguous()
        return accumulate_single(f32(nu_loc), windows[s_i], f32(kl.nu_c),
                                 f32(kl.scale_x), f32(kl.y), f32(kl.amps),
                                 cutoff_cm1=cutoff_cm1)

    def body(nu_loc: torch.Tensor, mine: KernelLines, *,
             side=None) -> torch.Tensor:
        pending = _start_halo(mine, mesh, n_shards, stream=side)
        with annotate(OWN_SUM_RANGE):
            out = acc(nu_loc, mine, 0)
        for (_, s_i), (rows,) in zip(_hops(n_shards), pending.wait()):
            out = out + acc(nu_loc, unpack_lines(rows), s_i)
        return out

    return GraphedBody(body)


def nu_shard_edges(nu_host, n_shards: int,
                   cutoff_cm1: Optional[float]) -> np.ndarray:
    """Shard ownership edges (equal grid-point counts), and the exactness
    check cutoff <= chunk width: a ValueError, since a TOML file reaches it
    (``compute.mesh_halo`` on a grid narrower than ``mesh_nu * cutoff``
    would let line wings cross beyond the adjacent shard)."""
    nu_host = _host64(nu_host)
    P_ = len(nu_host)
    if P_ % n_shards != 0:
        raise ValueError(
            f"grid.n_points ({P_}) must be divisible by the nu-mesh size "
            f"({n_shards}) — adjust grid.n_points or compute.mesh_nu")
    chunk_pts = P_ // n_shards
    edges = np.empty(n_shards + 1)
    edges[:-1] = nu_host[::chunk_pts]
    edges[-1] = nu_host[-1] + (nu_host[-1] - nu_host[-2])
    if cutoff_cm1 is not None:
        min_width = np.diff(edges).min()
        if cutoff_cm1 > min_width:
            raise ValueError(
                f"compute.mesh_halo exactness: wing cutoff "
                f"(compute.cutoff_cm1 = {cutoff_cm1} cm^-1) exceeds the "
                f"narrowest nu-shard width ({min_width:.3g} cm^-1 = grid "
                f"span / compute.mesh_nu), so line wings would reach beyond "
                f"the adjacent shard and the one-hop halo exchange would "
                f"drop them.  Fix one of: lower compute.cutoff_cm1, lower "
                f"compute.mesh_nu, widen grid.nu_min/nu_max, or disable "
                f"compute.mesh_halo (the psum tier has no width "
                f"requirement).")
    return edges
