"""Batched opacity line sum on the card: the wrapper of the hand-written CUDA
kernel ``csrc/opacity_batch.cu``, its plain PyTorch version, and the host
window tables both share.

The kernel replaces the TPU kernel
``spectrobot_tpu/ops/pallas_opacity.py:_batch_kernel`` (K1), reached there
through ``accumulate_pallas_batch``:

    out[b, o, p] = sum_i amps[b, o, i] * Re w(x_bip, y_bi) * chi * [|dnu| <= cut]

for every (ray x layer) state b and both depths o (absorption, emission).

What bounds it on an H100: FP32 arithmetic on the CUDA cores, not bytes.
Per (point, line) pair the Humlicek evaluation costs, by tier (the
reference's ``bench.py:_dense_tier_mix`` / ``TIER_FLOPS`` reckoning), about
14 flops (far), 55 (mid), 165 (near3) and 300 (near4), while the inputs are
a few floats per line and per point.  The kernel's design works on the
instructions it issues per pair: dead states and out-of-window line blocks
are never evaluated, each 32-line sub-block is cut to its run of lines
that can reach the tile, the tier is picked once per sub-block so most
pairs run the 14-flop region-1 rational, near-tier pairs evaluate only
their own region, and each staged line (two shared-memory broadcasts)
serves two grid points per thread.  The line reduction (an MXU matmul on
the TPU) is an FMA into two registers per point, in line order, so the
sums are those of a plain loop over every line, bit for bit.  The kernel
reads the unpadded rows and decides which states are dead itself: the
wrapper allocates the output and launches it, nothing else.

Device rule: a CPU tensor goes to :func:`accumulate_batch_plain`; a CUDA
tensor always launches the kernel, and a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from spectrobot_tpu_torch.ops.opacity import KernelLines, accumulate_plain

# Kernel geometry; must equal the constants of csrc/opacity_batch.cu
# (checked against the library when it is loaded).
TILE_P = 128
BLOCK_L = 128
SUB_L = 32
TIERS = ("far", "mid", "near3", "near4")
# The windows are built from the unshifted centers, widened by this much to
# cover any pressure shift (the reference's default shift margin).
SHIFT_MARGIN_CM1 = 1.0

# Kernel launches made by accumulate_batch in this process.
LAUNCHES = 0
_LIB = None

# Elements per (state, line, point) slab of the plain version (bounds its
# intermediates to ~128 MB each in float32).
_PLAIN_SLAB = 1 << 25


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _block_windows(nu_host: np.ndarray, nuc_host: np.ndarray, tile_p: int,
                   block_l: int, cutoff: Optional[float]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """For each nu tile, the [start, count) of line BLOCKS whose lines can
    reach the tile given the wing cutoff (lines sorted by nu0).  A copy of
    ``spectrobot_tpu.ops.pallas_opacity._block_windows``."""
    n_tiles = len(nu_host) // tile_p
    n_blocks = len(nuc_host) // block_l
    if cutoff is None:
        starts = np.zeros(n_tiles, dtype=np.int32)
        counts = np.full(n_tiles, n_blocks, dtype=np.int32)
        return starts, counts
    blk_min = nuc_host.reshape(n_blocks, block_l).min(axis=1)
    blk_max = nuc_host.reshape(n_blocks, block_l).max(axis=1)
    tile_lo = nu_host.reshape(n_tiles, tile_p).min(axis=1)
    tile_hi = nu_host.reshape(n_tiles, tile_p).max(axis=1)
    # Block b is relevant to tile t iff [blk_min-cut, blk_max+cut] overlaps
    # [tile_lo, tile_hi].
    starts = np.searchsorted(blk_max, tile_lo - cutoff, side="left")
    ends = np.searchsorted(blk_min, tile_hi + cutoff, side="right")
    starts = np.minimum(starts, n_blocks).astype(np.int32)
    counts = np.maximum(ends - starts, 0).astype(np.int32)
    return starts, counts


def _tile_windows(nu_host: np.ndarray, nuc_host: np.ndarray, tile_p: int,
                  block_l: int, cutoff: Optional[float]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Transpose of :func:`_block_windows`: for each LINE BLOCK, the
    [start, count) of nu TILES it can reach given the wing cutoff.  A copy
    of ``spectrobot_tpu.ops.pallas_opacity._tile_windows``; it visits the
    same (tile, block) pairs as :func:`_block_windows`."""
    n_tiles = len(nu_host) // tile_p
    n_blocks = len(nuc_host) // block_l
    if cutoff is None:
        return (np.zeros(n_blocks, dtype=np.int32),
                np.full(n_blocks, n_tiles, dtype=np.int32))
    blk_min = nuc_host.reshape(n_blocks, block_l).min(axis=1)
    blk_max = nuc_host.reshape(n_blocks, block_l).max(axis=1)
    tile_lo = nu_host.reshape(n_tiles, tile_p).min(axis=1)
    tile_hi = nu_host.reshape(n_tiles, tile_p).max(axis=1)
    starts = np.searchsorted(tile_hi, blk_min - cutoff, side="left")
    ends = np.searchsorted(tile_lo, blk_max + cutoff, side="right")
    starts = np.minimum(starts, n_tiles).astype(np.int32)
    counts = np.maximum(ends - starts, 0).astype(np.int32)
    return starts, counts


def _padded_windows(nu_host: np.ndarray, nu0_host: np.ndarray, tile_p: int,
                    block_l: int, cutoff_cm1: Optional[float]):
    """Pad the grid and the unshifted centers as the reference pads them
    (grid points past the end 1e6 cm-1 beyond it, padded lines 1e7 cm-1
    beyond the last line) and build the windows over them, widened by
    ``SHIFT_MARGIN_CM1``: the line blocks of each tile (K1, K2) and the
    tiles of each line block (K5).  Returns (nu_pad, nu0_pad, far, starts,
    counts, starts_T, counts_T)."""
    P, L = len(nu_host), len(nu0_host)
    nu_pad = np.full(_round_up(max(P, tile_p), tile_p),
                     (nu_host.max() if P else 0.0) + 1e6, np.float32)
    nu_pad[:P] = nu_host
    far = np.float32((nu0_host.max() if L else 0.0) + 1e7)
    nu0_pad = np.full(_round_up(max(L, block_l), block_l), far, np.float32)
    nu0_pad[:L] = nu0_host
    win_cut = None if cutoff_cm1 is None else cutoff_cm1 + SHIFT_MARGIN_CM1
    starts, counts = _block_windows(nu_pad, nu0_pad, tile_p, block_l,
                                    win_cut)
    starts_T, counts_T = _tile_windows(nu_pad, nu0_pad, tile_p, block_l,
                                       win_cut)
    return nu_pad, nu0_pad, far, starts, counts, starts_T, counts_T


def static_windows(nu_host: np.ndarray, nu0_host: np.ndarray, *,
                   tile_p: int = TILE_P, block_l: int = BLOCK_L,
                   cutoff_cm1: Optional[float] = 25.0):
    """Ragged block windows over the padded grid and unshifted centers,
    widened by ``SHIFT_MARGIN_CM1`` to cover any pressure shift.  A copy of
    ``spectrobot_tpu.ops.pallas_opacity.static_windows`` at its default
    shift margin.

    Returns (starts [n_tiles] int32, counts [n_tiles] int32, max_blocks).
    """
    starts, counts = _padded_windows(
        np.asarray(nu_host, np.float32), np.asarray(nu0_host, np.float32),
        tile_p, block_l, cutoff_cm1)[3:5]
    max_blocks = max(int(counts.max()) if counts.size else 1, 1)
    return starts, counts, max_blocks


def static_windows_T(nu_host: np.ndarray, nu0_host: np.ndarray, *,
                     tile_p: int = TILE_P, block_l: int = BLOCK_L,
                     cutoff_cm1: Optional[float] = 25.0):
    """Per-BLOCK tile windows for the transpose kernel (K5), with the
    padding and margin of :func:`static_windows`.  A copy of
    ``spectrobot_tpu.ops.pallas_opacity.static_windows_T`` at its default
    shift margin.

    Returns (starts [n_blocks] int32, counts [n_blocks] int32, max_tiles).
    """
    starts, counts = _padded_windows(
        np.asarray(nu_host, np.float32), np.asarray(nu0_host, np.float32),
        tile_p, block_l, cutoff_cm1)[5:]
    max_tiles = max(int(counts.max()) if counts.size else 1, 1)
    return starts, counts, max_tiles


def _host32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


@dataclasses.dataclass(frozen=True, eq=False)
class Windows:
    """A scene's padded grid and ragged windows on its device, built once by
    :func:`line_windows` and read by the kernels (K1 and K2 the line blocks
    of each tile, K5 the tiles of each line block: the same pairs), so no
    call copies the grid or the centers to the host.  A plain class, not a
    tuple, so ``torch.func`` passes it through untouched."""
    nu_pad: torch.Tensor       # [Pp] float32 grid, padded 1e6 cm-1 beyond
    far: float                 # center given to padded lines
    starts: torch.Tensor       # [n_tiles] int32 first line block per tile
    counts: torch.Tensor       # [n_tiles] int32 line blocks per tile
    starts_T: torch.Tensor     # [n_blocks] int32 first tile per line block
    counts_T: torch.Tensor     # [n_blocks] int32 tiles per line block
    n_points: int              # P
    n_lines: int               # L
    cutoff_cm1: Optional[float]
    max_blocks: int            # the longest tile window, in line blocks
    max_tiles: int             # the longest line block window, in tiles


def line_windows(nu_grid, nu0_host, *, cutoff_cm1: Optional[float] = 25.0,
                 device=None) -> Windows:
    """The :class:`Windows` of a grid (offset coordinates, tensor or array)
    and its UNSHIFTED line centers (offsets, ascending), on ``device``
    (default: the grid's)."""
    nu, nu0 = _host32(nu_grid), _host32(nu0_host)
    if nu0.ndim != 1 or np.any(np.diff(nu0) < 0):
        raise ValueError("nu0_host must be the unshifted line centers in "
                         "ascending order (the windows assume it)")
    if device is None:
        device = (nu_grid.device if isinstance(nu_grid, torch.Tensor)
                  else torch.device("cpu"))
    nu_pad, _, far, *tables = _padded_windows(nu, nu0, TILE_P, BLOCK_L,
                                              cutoff_cm1)
    on = lambda a: torch.as_tensor(a, device=device)
    longest = lambda c: max(int(c.max()) if c.size else 0, 1)
    return Windows(on(nu_pad), float(far), *(on(t) for t in tables),
                   len(nu), len(nu0), cutoff_cm1, longest(tables[1]),
                   longest(tables[3]))


def all_block_windows(nu_grid, n_lines: int, *,
                      cutoff_cm1: Optional[float] = 25.0,
                      device=None) -> Windows:
    """The :class:`Windows` that visit every line block for every tile (the
    reference's all-blocks table, for a call that knows no centers) for
    ``n_lines`` lines under ``cutoff_cm1``; the per-pair cutoff mask alone
    keeps the sum exact."""
    w = line_windows(nu_grid, np.zeros(n_lines, np.float32),
                     cutoff_cm1=None, device=device)
    return dataclasses.replace(w, cutoff_cm1=cutoff_cm1)


def check_windows(nu_grid: torch.Tensor, windows, n_lines: int,
                  cutoff_cm1: Optional[float]) -> None:
    """Raise unless ``windows`` is the :class:`Windows` of this kernel call:
    built for this grid, ``n_lines`` lines and this cutoff, on the grid's
    device."""
    w = windows
    if not isinstance(w, Windows):
        raise TypeError(f"windows must be the scene's Windows "
                        f"(line_windows), got {type(w).__name__}")
    if (w.n_points, w.n_lines) != (nu_grid.shape[0], n_lines):
        raise ValueError(f"windows built for {w.n_lines} lines and "
                         f"{w.n_points} points, call has {n_lines} lines and "
                         f"{nu_grid.shape[0]} points")
    if w.cutoff_cm1 != cutoff_cm1:
        raise ValueError(f"windows built for cutoff {w.cutoff_cm1}, call "
                         f"asks for {cutoff_cm1}")
    if w.nu_pad.device != nu_grid.device:
        raise ValueError(f"windows are on {w.nu_pad.device}, nu_grid on "
                         f"{nu_grid.device}")


def pad_lines(a: torch.Tensor, Lp: int, fill: float) -> torch.Tensor:
    """Pad the line axis (last) of ``a`` to ``Lp`` with ``fill``, as one
    contiguous float32 tensor (no copy when nothing is to be done)."""
    L = a.shape[-1]
    a = a.to(torch.float32)
    if Lp != L:
        a = torch.nn.functional.pad(a, (0, Lp - L), value=fill)
    return a.contiguous()


def tier_counts(windows: Windows, nu_c, scale_x, y, amps) -> dict:
    """How many (live state, tile, sub-block) triples of the window tables
    the kernels (K1, K2 and K5) decide in each tier, reckoned on the host
    from the same window table, padding and float32 bound as the kernels
    (K1 and K5 then skip the lines, or tiles, of a triple that lie beyond
    the cutoff).  ``windows``: the
    call's :class:`Windows`; the line states as the kernel wrappers take
    them (tensors or arrays).  A state is live where its ``amps`` (any
    [B, ...] array) has a nonzero entry: K5 passes its cotangent rows, or
    a [B, 1] mask of them.  Returns {tier name: count}."""
    w = windows
    nu_pad = _host32(w.nu_pad)
    starts, counts = w.starts.cpu().numpy(), w.counts.cpu().numpy()
    nc, sx, yy, am = (_host32(a) for a in (nu_c, scale_x, y, amps))
    B, L = nc.shape
    Lp = _round_up(max(L, BLOCK_L), BLOCK_L)
    n_tiles, n_sub = len(nu_pad) // TILE_P, Lp // SUB_L

    def sub_blocks(a, fill):
        out = np.full((B, Lp), fill, np.float32)
        out[:, :L] = a
        return out.reshape(B, n_sub, SUB_L)

    ncs = sub_blocks(nc, np.float32(w.far))
    c_min, c_max = ncs.min(-1)[:, None, :], ncs.max(-1)[:, None, :]
    sx_min = sub_blocks(sx, 1e6).min(-1)[:, None, :]
    y_min = sub_blocks(yy, 1e6).min(-1)[:, None, :]
    tiles = nu_pad.reshape(n_tiles, TILE_P)
    lo = tiles.min(1)[None, :, None]
    hi = tiles.max(1)[None, :, None]
    gap = np.maximum(np.maximum(c_min - hi, lo - c_max), np.float32(0.0))
    s_min = gap * sx_min + y_min                    # [B, n_tiles, n_sub]
    tier = np.where(s_min >= 15.0, 0, np.where(
        s_min >= 5.5, 1, np.where(y_min >= 0.9, 2, 3)))
    blk = np.arange(n_sub) // (BLOCK_L // SUB_L)
    visited = ((blk[None, :] >= starts[:, None])
               & (blk[None, :] < (starts + counts)[:, None]))
    live = np.any(am.reshape(B, -1) != 0, axis=1)
    mask = live[:, None, None] & visited[None, :, :]
    return {name: int(np.sum((tier == k) & mask))
            for k, name in enumerate(TIERS)}


def accumulate_batch_plain(nu_grid, nu_c, scale_x, y, amps, *,
                           cutoff_cm1: Optional[float] = 25.0,
                           chi_b: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The plain PyTorch version of :func:`accumulate_batch`, any dtype and
    device: nu_c/scale_x/y [B, L], amps [B, n_out, L], chi_b [B, L] or
    None -> [B, n_out, P] in ``nu_grid``'s dtype.

    Every line is evaluated at every point (pointwise w4, cutoff mask), so
    it needs no window table.  States are taken in groups so that one
    (state, line, point) slab holds at most ``_PLAIN_SLAB`` elements, which
    keeps a full-size limb scan within a few GB on the card.
    """
    B, L = nu_c.shape
    chunk = min(max(L, 1), 256)
    group = max(1, _PLAIN_SLAB // (chunk * max(nu_grid.shape[0], 1)))
    return torch.cat([
        accumulate_plain(
            nu_grid, KernelLines(nu_c[g], scale_x[g], y[g], amps[g],
                                 None if chi_b is None else chi_b[g]),
            chunk=chunk, cutoff_cm1=cutoff_cm1)
        for g in (slice(b0, b0 + group) for b0 in range(0, B, group))])


def check_tensors(nu_grid: torch.Tensor, want: dict, *, kernel: bool,
                  note: str = "") -> None:
    """Raise unless each ``want[name] = (tensor, shape)`` is a tensor of that
    shape on ``nu_grid``'s device; with ``kernel``, also unless it is
    float32 and contiguous (what the kernels take).  ``note`` ends the shape
    error."""
    for name, (t, shape) in want.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != nu_grid.device:
            raise ValueError(f"{name} is on {t.device}, nu_grid on "
                             f"{nu_grid.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}{note}")
        if not kernel:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(nu_grid, nu_c, scale_x, y, amps, chi_b, *, kernel: bool) -> None:
    """Raise on inputs of the wrong shape or on mixed devices; with
    ``kernel``, also on anything else the kernel does not take (more than
    65535 states, a dtype other than float32, non-contiguous tensors)."""
    if nu_grid.dim() != 1:
        raise ValueError(f"nu_grid must be 1-D, got {tuple(nu_grid.shape)}")
    if nu_c.dim() != 2:
        raise ValueError(f"nu_c must be [B, L], got {tuple(nu_c.shape)}")
    B, L = nu_c.shape
    if kernel and B > 65535:
        raise ValueError(f"at most 65535 states per call, got {B}")
    want = {"nu_c": (nu_c, (B, L)), "scale_x": (scale_x, (B, L)),
            "y": (y, (B, L)), "amps": (amps, (B, 2, L))}
    if chi_b is not None:
        want["chi_b"] = (chi_b, (B, L))
    want["nu_grid"] = (nu_grid, tuple(nu_grid.shape))
    check_tensors(nu_grid, want, kernel=kernel,
                  note=" (the kernel sums exactly two depths)")


def _library() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        from spectrobot_tpu_torch.kernels import build

        lib = build.load("opacity_batch")
        geometry = (lib.opacity_batch_tile_p(), lib.opacity_batch_block_l(),
                    lib.opacity_batch_sub_l())
        if geometry != (TILE_P, BLOCK_L, SUB_L):
            raise RuntimeError(f"kernel geometry {geometry} != wrapper "
                               f"{(TILE_P, BLOCK_L, SUB_L)}")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        f32 = ctypes.c_float
        lib.opacity_batch_launch.argtypes = [ptr] * 9 + [
            i32, i32, i32, i32, f32, f32, ptr]
        lib.opacity_batch_launch.restype = i32
        lib.opacity_batch_error_string.argtypes = [i32]
        lib.opacity_batch_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def accumulate_batch(nu_grid: torch.Tensor, windows: Windows,
                     nu_c: torch.Tensor,
                     scale_x: torch.Tensor, y: torch.Tensor,
                     amps: torch.Tensor, *,
                     cutoff_cm1: Optional[float] = 25.0,
                     chi_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched line sum (counterpart of the reference's
    ``accumulate_pallas_batch``): nu_grid [P] (offset coordinates),
    nu_c/scale_x/y [B, L], amps [B, 2, L], chi_b [B, L] or None, all on one
    device -> [B, 2, P].  CUDA tensors must be float32 (the kernel's
    dtype); CPU tensors go to :func:`accumulate_batch_plain` in any dtype.

    ``windows``: the scene's :class:`Windows` (:func:`line_windows`, built
    once from the unshifted centers and widened by ``SHIFT_MARGIN_CM1`` to
    cover any pressure shift; the per-pair |dnu| <= cutoff mask keeps the
    result exact).  The plain version needs none.
    """
    global LAUNCHES
    on_cpu = nu_grid.device.type == "cpu"
    _check(nu_grid, nu_c, scale_x, y, amps, chi_b, kernel=not on_cpu)
    if on_cpu:
        return accumulate_batch_plain(nu_grid, nu_c, scale_x, y, amps,
                                      cutoff_cm1=cutoff_cm1, chi_b=chi_b)
    if nu_grid.device.type != "cuda":
        raise ValueError(f"no opacity kernel for device {nu_grid.device}")
    B, L = nu_c.shape
    P = nu_grid.shape[0]
    check_windows(nu_grid, windows, L, cutoff_cm1)
    win = windows
    lib = _library()

    dev = nu_grid.device
    out = torch.empty((B, 2, P), dtype=torch.float32, device=dev)
    cut = math.inf if cutoff_cm1 is None else float(cutoff_cm1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.opacity_batch_launch(
            win.nu_pad.data_ptr(), nu_c.data_ptr(), scale_x.data_ptr(),
            y.data_ptr(), None if chi_b is None else chi_b.data_ptr(),
            amps.data_ptr(), win.starts.data_ptr(), win.counts.data_ptr(),
            out.data_ptr(), B, P, win.nu_pad.shape[0], L, win.far, cut,
            stream)
        LAUNCHES += 1
    if rc != 0:
        msg = lib.opacity_batch_error_string(rc).decode()
        raise RuntimeError(f"opacity_batch kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    return out
