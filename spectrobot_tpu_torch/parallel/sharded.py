"""The forward model over the (ray, line, nu) mesh (port of
``spectrobot_tpu.parallel.sharded``).

* ``nu``   -- each rank owns a contiguous chunk of the fine grid.
* ``line`` -- each rank owns a slice of the (nu0-sorted) line list and sums
  PARTIAL depths on its chunk; one all-reduce over ``line`` completes them
  BEFORE the nonlinear source assembly, which keeps line sharding exact.
* ``ray``  -- tangent heights (nadir pixels) are pure data parallelism.

Two line distributions:

* ``nu_halo=False`` (the psum tier): every line slice is evaluated against
  the rank's chunk with the |dnu| <= cutoff mask; the ``line`` all-reduce is
  the only collective.
* ``nu_halo=True``: lines are OWNED by the nu shard holding their center
  (:func:`partition_lines_by_nu`); each rank adds its ring neighbours' line
  PARAMETERS, received by a ring shift, to its own.  Exact when the cutoff
  is at most one chunk wide (``halo.nu_shard_edges`` checks).  The shift
  of every hop is issued before the rank's own line sum and waited on
  after it (``collectives.ring_exchange_start``), as XLA overlaps the
  reference's permutes with its local accumulation; on constant inputs on
  the card the whole body is one CUDA graph in which the exchange is a
  branch beside the own line sum (``parallel.graphed``).

Each rank's line sums are the port's ``forward.limb.layer_tau_kernel``: K1
for the depths, K2 for their tangents under ``torch.func.jacfwd``, on
window tables built here, on the host, for this rank's (chunk, source,
line slice).  Every rank runs the same program on its own block
(:func:`stage_sharded`) and gets its [R_loc, P_loc] block of radiances.
A non-LTE state is replicated on every rank (its weights follow each
line, also the halo hops' lines); a collision-induced continuum is
additive per (ray, layer, nu) and line-free, so its tables are cut by the
rank's ``nu`` block and added in the epilogue.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from spectrobot_tpu_torch.data.nlte import DeviceNLTE
from spectrobot_tpu_torch.forward.geometry import PathCG
from spectrobot_tpu_torch.forward.limb import (
    layer_tau_kernel, tau_radiance_epilogue)
from spectrobot_tpu_torch.ops.cia import DeviceCIA
from spectrobot_tpu_torch.ops.cuda_basis import KERNELS
from spectrobot_tpu_torch.ops.cuda_opacity import line_windows
from spectrobot_tpu_torch.ops.opacity import Engine
from spectrobot_tpu_torch.ops.strengths import DeviceLines
from spectrobot_tpu_torch.parallel.collectives import (
    OWN_SUM_RANGE, psum, ring_exchange_start)
from spectrobot_tpu_torch.parallel.graphed import GraphedBody
from spectrobot_tpu_torch.parallel.halo import _hops, nu_shard_edges
from spectrobot_tpu_torch.utils.profiling import annotate

# Per-line DeviceLines fields (leading [L] axis); the trailing three
# (q_tbl, q_tgrid, nu_ref) are lookup state every rank holds whole.
PER_LINE_FIELDS = DeviceLines._fields[:11]
_INT_FIELDS = ("species_idx", "level_upper", "level_lower")
_REAL_FIELDS = tuple(f for f in PER_LINE_FIELDS if f not in _INT_FIELDS)

# Pad-line parameter fills: zero strength makes a pad line exactly inert in
# the linear line sum; the width and mass fills keep its (unused) Voigt
# arguments in normal float range.  The CENTER fill is a FAR sentinel, not
# 0.0: a mid-band pad breaks the sorted-centers invariant that the window
# tables (ops.cuda_opacity.line_windows) and the kernels' per-sub-block tier
# bounds rely on (a 0.0 pad ending a line block dropped real blocks from
# the reference's windows).
_PAD_NU0_FAR = 1.0e7
_PAD_FILLS = dict(
    nu0=_PAD_NU0_FAR, sw=0.0, elower=0.0, gamma_air=1e-3, gamma_self=1e-3,
    n_air=0.5, delta_air=0.0, mass_amu=40.0, species_idx=0,
    level_upper=-1, level_lower=-1,
)


class Staged(NamedTuple):
    """One rank's block of the forward's inputs (:func:`stage_sharded`)."""
    nu: torch.Tensor          # [P_loc] grid chunk
    nu_off: torch.Tensor      # [P_loc] the chunk in offset coordinates
    lines: DeviceLines        # the rank's line slice, [L_loc] per line
    cg: PathCG                # the rank's rays, [R_loc, ...]
    I_bg: Optional[torch.Tensor]   # [P_loc] background, or None
    nlte: Optional[DeviceNLTE] = None   # the non-LTE state (replicated)
    cia: Optional[DeviceCIA] = None     # continuum tables [n_pair, nT, P_loc]


def pad_lines_for_mesh(lines: DeviceLines, n_shards: int) -> DeviceLines:
    """Pad the line axis to a multiple of the line-mesh size with
    zero-strength lines (inert in the linear line sum)."""
    L = lines.n_lines
    pad = -L % n_shards
    if pad == 0:
        return lines
    return lines._replace(**{
        f: torch.cat([getattr(lines, f), torch.full(
            (pad,), fill, dtype=getattr(lines, f).dtype,
            device=getattr(lines, f).device)])
        for f, fill in _PAD_FILLS.items()})


def partition_lines_by_nu(lines: DeviceLines, nu_host, n_nu: int, *,
                          cutoff_cm1: Optional[float] = 25.0,
                          line_shards: int = 1,
                          round_to: int = 128) -> DeviceLines:
    """Host-side owner-shard line partition for the nu-halo tier: each line
    goes to the nu shard whose grid interval holds its (unshifted) center;
    the shards' slices are padded to a common Lmax (a multiple of
    ``round_to * line_shards``) with zero-strength lines.  The per-line
    fields of the result are [n_nu, Lmax].

    Exactness needs a line's wing to reach at most the ADJACENT shard
    (``halo.nu_shard_edges`` raises otherwise); lines whose centers fall
    outside the grid attach to the first or last shard."""
    nu_host = np.asarray(nu_host, np.float64)
    edges = nu_shard_edges(nu_host, n_nu, cutoff_cm1)
    # Centers in absolute coordinates (nu0 is an offset from nu_ref; the
    # partition is host float64, so no precision is lost).
    nu0_abs = (lines.nu0.detach().cpu().numpy().astype(np.float64)
               + float(lines.nu_ref))
    if np.any(np.diff(nu0_abs) < 0):
        raise ValueError("the line list must be sorted by nu0")
    cuts = np.concatenate([[0], np.searchsorted(nu0_abs, edges[1:-1]),
                           [len(nu0_abs)]])
    m = round_to * max(line_shards, 1)
    Lmax = max(int(np.diff(cuts).max()), 1)
    Lmax = ((Lmax + m - 1) // m) * m

    out = {}
    for f, fill in _PAD_FILLS.items():
        a = getattr(lines, f)
        buf = torch.full((n_nu, Lmax), fill, dtype=a.dtype, device=a.device)
        for k in range(n_nu):
            seg = a[cuts[k]:cuts[k + 1]]
            buf[k, :len(seg)] = seg
        out[f] = buf
    return lines._replace(**out)


def local_lines(mesh, lines: DeviceLines) -> DeviceLines:
    """This rank's line slice over ``line``: of the sorted list (per-line
    fields [Lp]), or of its own nu shard's row of the nu-halo layout
    (per-line fields [n_nu, Lmax], :func:`partition_lines_by_nu`)."""
    halo = lines.nu0.dim() == 2

    def line_slice(a):
        if halo:
            a = a[mesh.coord["nu"]]
        return a[mesh.block(a.shape[0], "line")]

    return lines._replace(**{f: line_slice(getattr(lines, f))
                             for f in PER_LINE_FIELDS})


def local_cia(mesh, cia: Optional[DeviceCIA],
              n_points: int) -> Optional[DeviceCIA]:
    """This rank's block of the continuum: the tables' grid axis cut by its
    ``nu`` block of the ``n_points``-point grid."""
    if cia is None:
        return None
    return cia._replace(tables=cia.tables[:, :, mesh.block(n_points, "nu")])


def stage_sharded(mesh, nu_grid: torch.Tensor, lines: DeviceLines,
                  cg: PathCG, I_bg: Optional[torch.Tensor] = None,
                  nu_off: Optional[torch.Tensor] = None,
                  nlte: Optional[DeviceNLTE] = None,
                  cia: Optional[DeviceCIA] = None) -> Staged:
    """This rank's block of the forward's inputs: its grid chunk (and of
    ``nu_off``, default ``nu_grid - lines.nu_ref``), its rays, its line
    slice (:func:`local_lines`), its chunk of ``I_bg`` [P] and of the
    continuum's tables (:func:`local_cia`), and the whole non-LTE state."""
    if nu_off is None:
        nu_off = nu_grid - lines.nu_ref.to(nu_grid.dtype)
    nb = mesh.block(nu_grid.shape[0], "nu")
    rb = mesh.block(cg.u.shape[0], "ray")
    cg_loc = cg._replace(**{
        f: getattr(cg, f)[rb] for f in ("u", "T_sp", "p_sp", "p_self_sp",
                                        "T_air", "u_air", "uu_air")
        if getattr(cg, f) is not None})
    return Staged(nu_grid[nb], nu_off[nb], local_lines(mesh, lines), cg_loc,
                  None if I_bg is None else I_bg[nb], nlte,
                  local_cia(mesh, cia, nu_grid.shape[0]))


def _line_messages(lines: DeviceLines) -> list:
    """The nu-halo tier's messages of a line slice: its per-line fields in
    two (reals, integers), each a sequence of [L] rows
    (``collectives.ring_exchange_start``)."""
    return [[getattr(lines, f) for f in _REAL_FIELDS],
            [getattr(lines, f) for f in _INT_FIELDS]]


def _received_lines(lines: DeviceLines, got) -> DeviceLines:
    """``lines`` with the per-line fields of the received messages
    ``got`` (:func:`_line_messages`' layout)."""
    real, ints = got
    return lines._replace(**dict(zip(_REAL_FIELDS, real)),
                          **dict(zip(_INT_FIELDS, ints)))


def _rank_windows(mesh, win_grid, win_lines, nu_halo: bool,
                  cutoff_cm1: Optional[float]) -> dict:
    """This rank's window tables, by source (0: its own lines; 1, 2: those
    of its left and right nu neighbour in the halo tier), built on the host
    from the global offset grid [P] and the line centers (the padded sorted
    list [Lp], or the halo tier's owner buffer [n_nu, Lmax])."""
    n_nu, k = mesh.shape["nu"], mesh.coord["nu"]
    g = np.asarray(win_grid, np.float64)
    grid_k = g[mesh.block(g.shape[0], "nu")]
    arr = np.asarray(win_lines, np.float64)
    if nu_halo != (arr.ndim == 2):
        raise ValueError("win_lines must be the owner buffer [n_nu, Lmax] "
                         "in the nu-halo tier and the sorted list [Lp] "
                         "otherwise")
    if not nu_halo:
        return {0: line_windows(grid_k, arr[mesh.block(arr.shape[0], "line")],
                                cutoff_cm1=cutoff_cm1, device=mesh.device)}
    src = (k, (k - 1) % n_nu, (k + 1) % n_nu)
    return {s_i: line_windows(
                grid_k, arr[src[s_i]][mesh.block(arr.shape[1], "line")],
                cutoff_cm1=cutoff_cm1, device=mesh.device)
            for s_i in (0,) + tuple(s for _, s in _hops(n_nu))}


def sharded_radiance_fn(mesh, *, win_grid, win_lines,
                        cutoff_cm1: Optional[float] = 25.0,
                        engine: Engine = KERNELS, nu_halo: bool = False,
                        is_limb: bool = True, emissivity: float = 1.0,
                        analytic_jvp=True, chi=None):
    """Build the sharded radiance function of this rank:
    f(nu_loc, nu_off_loc, lines_loc, cg_loc, I_bg=None, nlte=None,
    cia=None) -> I_loc [R_loc, P_loc], the arguments as
    :func:`stage_sharded` gives them (``nlte``: the non-LTE state, which
    weights every line sum, the halo hops' too; ``cia``: the rank's block
    of the continuum, added in the epilogue).

    ``win_grid``/``win_lines``: the global offset grid [P] and line centers
    (psum tier: the padded sorted list [Lp]; nu-halo tier:
    :func:`partition_lines_by_nu`'s [n_nu, Lmax] buffer), host arrays from
    which this rank's window tables are built once.  ``engine``,
    ``analytic_jvp``, ``chi``: as ``forward.limb.layer_tau_kernel`` takes
    them.
    ``is_limb=False`` integrates nadir rays over a grey surface: ``I_bg``
    carries eps B(T_surface), and for ``emissivity < 1`` the reflected
    downwelling is added from the same layer optics.  Nadir needs no
    collective beyond the line all-reduce.

    The function is a ``parallel.graphed.GraphedBody``: on constant inputs
    on the card it replays the body as one CUDA graph per input key, the
    exchange a branch beside the own line sum; its ``body`` is the eager
    body.
    """
    hops = _hops(mesh.shape["nu"]) if nu_halo else ()
    windows = _rank_windows(mesh, win_grid, win_lines, nu_halo, cutoff_cm1)

    def body(nu_loc, nu_off_loc, lines_loc: DeviceLines, cg_loc: PathCG,
             I_bg: Optional[torch.Tensor] = None,
             nlte: Optional[DeviceNLTE] = None,
             cia: Optional[DeviceCIA] = None, *, side=None) -> torch.Tensor:
        def tau(lines, s_i):
            return layer_tau_kernel(nu_off_loc, lines, cg_loc, windows[s_i],
                                    cutoff_cm1=cutoff_cm1, engine=engine,
                                    analytic_jvp=analytic_jvp, chi=chi,
                                    nlte=nlte)

        # Wing halos: neighbour-owned lines within the cutoff of this
        # chunk's edges; far (wrap-around) lines fall outside the mask.
        # Centers are global-origin offsets, so they need no shift.  The
        # exchange is issued before this rank's own line sum (K1, and K2
        # under jacfwd) and waited on after it, so the two overlap; under
        # capture it is issued from the stream ``side``, a branch of its own.
        pending = ring_exchange_start(_line_messages(lines_loc), mesh, "nu",
                                      [shift for shift, _ in hops],
                                      stream=side)
        with annotate(OWN_SUM_RANGE):
            dtau, dtau_em = tau(lines_loc, 0)
        for (_, s_i), got in zip(hops, pending.wait()):
            d2, d2e = tau(_received_lines(lines_loc, got), s_i)
            dtau, dtau_em = dtau + d2, dtau_em + d2e
        # Complete the line sums across the line axis: one all-reduce.
        dtau, dtau_em = psum(torch.stack([dtau, dtau_em]), mesh, "line")
        return tau_radiance_epilogue(nu_loc.to(dtau.dtype), cg_loc, dtau,
                                     dtau_em, cia=cia, I_background=I_bg,
                                     is_limb=is_limb, emissivity=emissivity)

    return GraphedBody(body)
