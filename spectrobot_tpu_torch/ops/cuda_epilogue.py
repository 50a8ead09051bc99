"""The RT epilogue on the card: the wrapper of the hand-written CUDA kernel
``csrc/rt_epilogue.cu`` and the autograd Functions that take a
forward-mode Jacobian's tangent columns through it in one launch.

The epilogue of a limb ray set, or of nadir rays over a black surface: the
source assembly S_l = B_nu(T_l) k_em / k_abs (``forward.limb.
optics_from_tau``, the ratio 1 in LTE) and the layer-path integral of
``forward.rt.layer_path_radiance`` in ``seg_layer`` order, observer first,

    I = sum_k S_l(k) (t_k - t_{k+1}) + I_bg t_end,   t_k = exp(-c_{k-1}).

No TPU kernel is replaced: the JAX package leaves it to XLA, which fuses
it.  Its tangent is linear in the tangents of T_air, the two depths and the
background, with coefficients of the primal alone (``csrc/rt_epilogue.cu``
derives them):

    dI = sum_l dT_l a_l + d_em_l b_l + d_tau_l g_l + d_bg t_end,

so the kernel walks each (ray, point)'s segments once, turns the walk's
sums into a_l, b_l, g_l and contracts every tangent column with them,
reading each depth tangent once, in place (by strides: K2's unfolded
output under ``torch.func.jacfwd`` is never copied).  In LTE
(``dtau_em`` None) the ratio is 1 and its tangent 0, so the emission row
is not read.  The types are the composed ops' promotions: the path sums
in the depths' dtype, the sources and the output in T_air's (a float64
atmosphere over float32 depths keeps its float64 sources), with
``optics_from_tau``'s thresholds.

Device rule: CPU tensors go to the plain version, the composed ops
(:func:`composed_radiance`, :func:`composed_tangent`); a CUDA tensor
always launches the kernel, and a ray set the kernel does not take, a
build or a launch failure raises.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Optional

import torch

from spectrobot_tpu_torch.constants import C1B, C2
from spectrobot_tpu_torch.forward.rt import layer_path_radiance
from spectrobot_tpu_torch.ops.cuda_single import current_stream
from spectrobot_tpu_torch.ops.opacity import _map_batch

# The kernel's geometry (csrc/rt_epilogue.cu, checked when it is loaded):
# grid points a block, thread rows of a tangent launch, shared memory a
# block may use.
TILE_P = 64
COL_GROUPS = 4
SHARED_MAX = 232448
# The kernel's instances by (depth dtype, source dtype): its ``types``.
TYPES = {(torch.float32, torch.float32): 0, (torch.float64, torch.float64): 1,
         (torch.float32, torch.float64): 2}

# Kernel launches made by radiance and radiance_tangent in this process (a
# graph's capture and replays as ``parallel.graphed`` counts them).
LAUNCHES = 0
_LIB = None
# A zero of each (device, dtype), broadcast in place of an absent tangent
# or background.
_ZEROS: dict = {}


def shared_bytes(n_layers: int, n_seg: int, itemsize: int,
                 tangent: bool = True) -> int:
    """The kernel's shared memory a block: [NL][TILE_P] arrays (four in a
    tangent launch, two in a primal one) and two [TILE_P] rows of the
    source dtype (``itemsize``), and the segment order and crossing counts
    as ints."""
    rows = (4 if tangent else 2) * n_layers + 2
    return rows * TILE_P * itemsize + (n_seg + n_layers) * 4


def takes(n_layers: int, n_seg: int, dtype: torch.dtype) -> bool:
    """Whether a block of ``n_layers`` layers and ``n_seg`` segments with
    sources in ``dtype`` fits the kernel's shared memory."""
    itemsize = torch.finfo(dtype).bits // 8
    return shared_bytes(n_layers, n_seg, itemsize) <= SHARED_MAX


def source_dtype(dtau: torch.Tensor, T_air: torch.Tensor,
                 I_bg: Optional[torch.Tensor] = None) -> torch.dtype:
    """The dtype of the sources and the radiance: the composed ops'
    promotion of the depths', T_air's and the background's (float32 or
    float64 each), float64 where any is."""
    wide = any(t is not None and t.dtype == torch.float64
               for t in (dtau, T_air, I_bg))
    return torch.float64 if wide else torch.float32


def composed_radiance(nu, T_air, dtau, dtau_em, seg_layer,
                      I_bg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`radiance`, any device: the composed
    PyTorch ops (``forward.limb.optics_from_tau`` +
    ``forward.rt.layer_path_radiance``)."""
    from spectrobot_tpu_torch.forward.limb import optics_from_tau

    optics = optics_from_tau(nu, SimpleNamespace(T_air=T_air), dtau,
                             dtau if dtau_em is None else dtau_em)
    return layer_path_radiance(optics.dtau, optics.source, seg_layer, I_bg)


def composed_tangent(nu, T_air, dtau, dtau_em, seg_layer, I_bg, dT, d_tau,
                     d_em, d_bg) -> torch.Tensor:
    """The plain version of :func:`radiance_tangent`, any device: the
    vmapped ``torch.func.jvp`` of :func:`composed_radiance` over the
    columns (None: zero)."""
    n_t = _columns(dT, d_tau, d_em, d_bg)
    pairs = [(p, t) for p, t in ((T_air, dT), (dtau, d_tau), (dtau_em, d_em),
                                 (I_bg, d_bg)) if p is not None]
    # A broadcast primal (a nadir background) cannot carry a dual tangent.
    primals = tuple(p.contiguous() if 0 in p.stride() else p
                    for p, _ in pairs)
    tangents = tuple(torch.zeros_like(p).expand((n_t,) + p.shape)
                     if t is None else t for p, t in pairs)

    def f(*args):
        it = iter(args)
        T, tau = next(it), next(it)
        em = next(it) if dtau_em is not None else None
        bg = next(it) if I_bg is not None else None
        return composed_radiance(nu, T, tau, em, seg_layer, bg)

    return torch.func.vmap(
        lambda *t: torch.func.jvp(f, primals, t)[1])(*tangents)


def _columns(*tangents) -> int:
    """The tangents' column count (their leading axis; 1 if all are
    None)."""
    return next((t.shape[0] for t in tangents if t is not None), 1)


def _library() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        from spectrobot_tpu_torch.kernels import build

        lib = build.load("rt_epilogue")
        geometry = (lib.rt_epilogue_tile_p(), lib.rt_epilogue_col_groups(),
                    lib.rt_epilogue_shared_max())
        if geometry != (TILE_P, COL_GROUPS, SHARED_MAX):
            raise RuntimeError(f"kernel geometry {geometry} != wrapper "
                               f"{(TILE_P, COL_GROUPS, SHARED_MAX)}")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rt_epilogue_launch.argtypes = [i32, i32, i32, ptr, ptr, ptr,
                                           ctypes.c_double, ctypes.c_double,
                                           ptr]
        lib.rt_epilogue_launch.restype = i32
        lib.rt_epilogue_error_string.argtypes = [i32]
        lib.rt_epilogue_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _zero(dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A zero of ``dtype`` on ``dev``, made once and kept."""
    key = (dev, dtype)
    if key not in _ZEROS:
        _ZEROS[key] = torch.zeros((), dtype=dtype, device=dev)
    return _ZEROS[key]


def _check(nu, T_air, dtau, dtau_em, seg_layer, I_bg, tangents=()) -> None:
    """Raise on inputs of the wrong shape, dtype or device (the shapes of
    the tangents [n_t, ...] included): float32 or float64 depths, the grid,
    the emission depth and the depth tangents in their dtype, T_air, the
    background and their tangents in a float dtype whose promotion with it
    is float32 or float64."""
    if dtau.dim() != 3:
        raise ValueError(f"dtau must be [R, NL, P], got {tuple(dtau.shape)}")
    if dtau.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtau must be float32 or float64, got {dtau.dtype}")
    R, NL, P = dtau.shape
    n_t = _columns(*tangents)
    want = {"nu": (nu, (P,), True), "T_air": (T_air, (R, NL), False),
            "dtau_em": (dtau_em, (R, NL, P), True),
            "I_bg": (I_bg, (R, P), False)}
    for name, t, shape, same in zip(
            ("dT", "d_tau", "d_em", "d_bg"), tangents,
            ((R, NL), (R, NL, P), (R, NL, P), (R, P)),
            (False, True, True, False)):
        want[name] = (t, (n_t,) + shape, same)
    for name, (t, shape, same) in want.items():
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        ok = (t.dtype == dtau.dtype if same else t.dtype in
              (torch.float32, torch.float64))
        if not ok or t.device != dtau.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, dtau "
                            f"{dtau.dtype} on {dtau.device}")
    if (seg_layer.dim() != 1 or seg_layer.dtype != torch.int64
            or seg_layer.device != dtau.device):
        raise TypeError("seg_layer must be a 1-D int64 tensor on dtau's "
                        "device")


def _launch(out, nu, T_air, dtau, dtau_em, seg_layer, I_bg,
            tangents=None) -> torch.Tensor:
    """One kernel launch writing ``out`` (in the source dtype): the primal,
    or with ``tangents`` (dT, d_tau, d_em, d_bg; None broadcasts a zero)
    every column.  Raises where the ray set does not fit a block."""
    global LAUNCHES
    R, NL, P = dtau.shape
    ts = out.dtype
    if not takes(NL, seg_layer.shape[0], ts):
        raise ValueError(
            f"the fused epilogue takes ray sets whose block fits "
            f"{SHARED_MAX} B of shared memory; {NL} layers and "
            f"{seg_layer.shape[0]} segments with {ts} sources need "
            f"{shared_bytes(NL, seg_layer.shape[0], out.element_size())} B: "
            f"take fewer levels, or the plain engine (compute.use_pallas "
            f"= false)")
    if not seg_layer.is_contiguous():
        raise ValueError("seg_layer must be contiguous")
    dev = dtau.device
    fill = lambda t, shape, dtype: (_zero(dev, dtype).expand(shape)
                                    if t is None else
                                    t if t.dtype == dtype else t.to(dtype))
    T_air = fill(T_air, (R, NL), ts)
    I_bg = fill(I_bg, (R, P), ts)
    tangent = tangents is not None
    n_t = out.shape[0] if tangent else 0
    if tangent:
        dT, d_tau, d_em, d_bg = tangents
        tangents = (fill(dT, (n_t, R, NL), ts),
                    fill(d_tau, (n_t, R, NL, P), dtau.dtype),
                    None if dtau_em is None
                    else fill(d_em, (n_t, R, NL, P), dtau.dtype),
                    fill(d_bg, (n_t, R, P), ts))
    else:
        tangents = (None,) * 4
    args = (nu, T_air, dtau, dtau_em, seg_layer, I_bg, *tangents, out)
    ptrs = (ctypes.c_void_p * 11)(*(None if t is None else t.data_ptr()
                                    for t in args))
    strides = []
    for t, rank in zip(args[:4] + args[5:10], (1, 2, 3, 3, 2, 3, 4, 4, 3)):
        strides += [0] * rank if t is None else list(t.stride())
    dims = (ctypes.c_longlong * 5)(R, NL, P, seg_layer.shape[0], n_t)
    lib = _library()
    rc = lib.rt_epilogue_launch(
        dev.index, TYPES[(dtau.dtype, ts)], int(tangent), ptrs, dims,
        (ctypes.c_longlong * 25)(*strides), C1B, C2,
        current_stream(dev.index))
    LAUNCHES += 1
    if rc != 0:
        msg = lib.rt_epilogue_error_string(rc).decode()
        raise RuntimeError(f"rt_epilogue kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    return out


def radiance(nu, T_air, dtau, dtau_em, seg_layer,
             I_bg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The epilogue's radiances [R, P], in :func:`source_dtype`, of nu
    [P], T_air [R, NL], dtau and dtau_em [R, NL, P] (dtau_em None: LTE),
    seg_layer [n_seg] int64 (observer first) and I_bg [R, P] (None: deep
    space), on one device; any strides.  CUDA tensors launch the kernel
    once; CPU tensors go to :func:`composed_radiance`."""
    _check(nu, T_air, dtau, dtau_em, seg_layer, I_bg)
    if dtau.device.type == "cpu":
        return composed_radiance(nu, T_air, dtau, dtau_em, seg_layer, I_bg)
    if dtau.device.type != "cuda":
        raise ValueError(f"no epilogue kernel for device {dtau.device}")
    out = torch.empty(dtau.shape[::2], device=dtau.device,
                      dtype=source_dtype(dtau, T_air, I_bg))
    return _launch(out, nu, T_air, dtau, dtau_em, seg_layer, I_bg)


def radiance_tangent(nu, T_air, dtau, dtau_em, seg_layer, I_bg,
                     dT, d_tau, d_em, d_bg) -> torch.Tensor:
    """The epilogue's tangent [n_t, R, P] at the primal of
    :func:`radiance`, for tangent columns dT [n_t, R, NL], d_tau and d_em
    [n_t, R, NL, P], d_bg [n_t, R, P] (None: zero; d_em is not read in
    LTE), read in place by their strides.  CUDA tensors launch the kernel
    once for every column; CPU tensors go to :func:`composed_tangent`."""
    tangents = (dT, d_tau, d_em, d_bg)
    _check(nu, T_air, dtau, dtau_em, seg_layer, I_bg, tangents)
    if dtau.device.type == "cpu":
        return composed_tangent(nu, T_air, dtau, dtau_em, seg_layer, I_bg,
                                *tangents)
    if dtau.device.type != "cuda":
        raise ValueError(f"no epilogue kernel for device {dtau.device}")
    R, _, P = dtau.shape
    out = torch.empty((_columns(*tangents), R, P), device=dtau.device,
                      dtype=source_dtype(dtau, T_air, I_bg))
    return _launch(out, nu, T_air, dtau, dtau_em, seg_layer, I_bg, tangents)


class RadianceEpilogue(torch.autograd.Function):
    """``apply(nu, T_air, dtau, dtau_em, seg_layer, I_bg)`` -> [R, P]
    through :func:`radiance`; its forward-mode derivative is
    :class:`EpilogueTangent` (the grid and the segment order carry none).
    A structural vmap (a batched primal) takes one call an element
    (``ops.opacity._map_batch``)."""

    @staticmethod
    def forward(nu, T_air, dtau, dtau_em, seg_layer, I_bg):
        return radiance(nu, T_air, dtau, dtau_em, seg_layer, I_bg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, _d_nu, d_T, d_tau, d_em, _d_seg, d_bg):
        nu, T_air, dtau, dtau_em, seg_layer, I_bg = ctx.saved_tensors
        col = lambda d, primal: (None if d is None or primal is None
                                 else d.unsqueeze(0))
        return EpilogueTangent.apply(
            nu, T_air, dtau, dtau_em, seg_layer, I_bg, col(d_T, T_air),
            col(d_tau, dtau), col(d_em, dtau_em), col(d_bg, I_bg)).squeeze(0)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _map_batch(RadianceEpilogue.apply, info.batch_size, in_dims,
                          args), 0


class EpilogueTangent(torch.autograd.Function):
    """``apply(nu, T_air, dtau, dtau_em, seg_layer, I_bg, dT, d_tau, d_em,
    d_bg)`` -> [n_t, R, P] through :func:`radiance_tangent`, the tangents
    with a leading axis of columns.  Its vmap rule folds the tangent batch
    of ``torch.func.jacfwd`` (only tangents batched) into the columns by
    views, so every column goes through one call; a structural batch (the
    primal batched) takes one call an element."""

    @staticmethod
    def forward(nu, T_air, dtau, dtau_em, seg_layer, I_bg, dT, d_tau, d_em,
                d_bg):
        return radiance_tangent(nu, T_air, dtau, dtau_em, seg_layer, I_bg,
                                dT, d_tau, d_em, d_bg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        n = info.batch_size
        if any(d is not None for d in in_dims[:6]):
            return _map_batch(EpilogueTangent.apply, n, in_dims, args), 0

        def fold(t, d):          # [n, n_t, ...] -> [n * n_t, ...]
            if t is None:
                return None
            t = t.expand((n,) + t.shape) if d is None else t.movedim(d, 0)
            return t.flatten(0, 1)

        tangents = [fold(t, d) for t, d in zip(args[6:], in_dims[6:])]
        out = EpilogueTangent.apply(*args[:6], *tangents)
        return out.unflatten(0, (n, -1)), 0
