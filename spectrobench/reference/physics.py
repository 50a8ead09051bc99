"""The plain reference of a limb scene: the same physics as the port's
line-by-line limb forward, written again in plain PyTorch, with no kernel,
no window table and no cache.

It imports nothing of the port.  Its parts are frozen copies of the
port's formulas: the hydrostatic Mars standard atmosphere
(``data/atmosphere.py``), the CO2 partition sum (``data/tips.py``, the
anchored rigid-rotor x harmonic-oscillator table on the 5 K grid, read by
linear interpolation), the line strengths, widths and shifts
(``ops/strengths.py``), the Curtis-Godson limb paths (``forward/
geometry.py``), Humlicek's w4 (``ops/voigt.py``), the layer radiative
transfer with a Planck source (``forward/rt.py``, ``ops/planck.py``) and
the Gaussian instrument function (``ops/ils.py``).

The line sum is evaluated where the work is: region I of w4 on every pair
within the cutoff, regions II to IV only on the pairs with |x| + y < 15
(the same formula each pair would take in a branchless evaluation), and
only for the states whose column is not zero; the lines within reach of a
block of grid points are a contiguous run of the sorted list.

The reference computes in the precision the configuration states, staged
as the program's configuration defines it: the state, the geometry and the
per-line inputs in the dtype the caller holds the state in (``state_dtype``:
the CLI's retrieval casts its atmosphere to the compute dtype, its forward
keeps it in float64), the line sum in ``compute.dtype`` (float32), the
grid and the line centres as offsets staged from float64.  ``precision``:
"float32" is the reference; "tf32" is the control of the benchmark's
comparison, the same computation with every matrix product's inputs
(the line sum's contraction, the instrument function) rounded to TF32 (10
explicit mantissa bits, round to nearest even) and summed in float32, as a
tensor-core TF32 product does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import forward_ad as fwAD

# CODATA 2018, SI (the port's constants).
C_LIGHT = 2.99792458e8
H_PLANCK = 6.62607015e-34
K_BOLTZ = 1.380649e-23
AMU = 1.66053906660e-27
ATM = 101325.0
T_REF = 296.0
C2 = H_PLANCK * C_LIGHT / K_BOLTZ * 100.0
C1B = 2.0 * H_PLANCK * C_LIGHT ** 2 * 1.0e8
LN2 = math.log(2.0)
SQRT_LN2 = math.sqrt(LN2)
INV_SQRT_PI = 1.0 / math.sqrt(math.pi)
SQRT_LN2_PI = math.sqrt(LN2 / math.pi)

# Mars (radius [m], surface gravity [m/s^2], mean molecular mass [amu]).
MARS_RADIUS_M, MARS_G0, MARS_MU_AMU = 3389.5e3, 3.711, 43.34

# Humlicek region-3/4 rational coefficients, highest degree first.
_N3 = (0.5642236, 3.778987, 11.96482, 20.20933, 16.4955)
_D3 = (1.0, 6.699398, 21.69274, 39.27121, 38.82363, 16.4955)
_P4 = (0.56419, -1.320522, 35.76683, -219.0313, 1540.787, -3321.9905,
       36183.31)
_Q4 = (-1.0, 1.841439, -61.57037, 364.2191, -2186.181, 9022.228, -24322.84,
       32066.6)

# Pairs a slab of the line sum holds (its temporaries are a few times
# that in the working dtype).
PAIRS_PER_SLAB = 1 << 24
# Grid points a block of the line sum spans.
POINTS_PER_BLOCK = 512

PRECISIONS = ("float32", "tf32")


# ---------------------------------------------------------------------------
# Host-side inputs: the atmosphere and the partition sum.
# ---------------------------------------------------------------------------


def mars_standard(n_lev: int, z_top: float) -> dict:
    """The Mars standard atmosphere on ``n_lev`` levels to ``z_top`` [m]:
    z, p, T, n and vmr_<species> [n_lev], float64 (hydrostatic, integrated
    with midpoint steps from 610 Pa at the surface)."""
    z = np.linspace(0.0, z_top, n_lev)
    T = (145.0 + 65.0 * np.exp(-z / 35e3)
         + 8.0 * np.exp(-((z - 70e3) / 12e3) ** 2))
    mu = MARS_MU_AMU * AMU
    p = np.empty_like(z)
    p[0] = 610.0
    for i in range(1, n_lev):
        zm = 0.5 * (z[i] + z[i - 1])
        g = MARS_G0 * (MARS_RADIUS_M / (MARS_RADIUS_M + zm)) ** 2
        H = K_BOLTZ * 0.5 * (T[i] + T[i - 1]) / (mu * g)
        p[i] = p[i - 1] * np.exp(-(z[i] - z[i - 1]) / H)
    return {"z": z, "p": p, "T": T, "n": p / (K_BOLTZ * T),
            "vmr_CO2": np.full(n_lev, 0.9532),
            "vmr_CO": np.full(n_lev, 7.0e-4),
            "vmr_H2O": 2.0e-4 * np.exp(-z / 20e3),
            "vmr_N2": np.full(n_lev, 0.027)}


# The partition sum's temperature grid [K] (5 K spacing).
T_GRID = np.linspace(20.0, 1500.0, 297)


def q_table_co2() -> np.ndarray:
    """Q(T) of 12C16O2 on ``T_GRID``: the rigid-rotor sum (B = 0.39022
    cm-1, sigma = 2, J to 400) times the harmonic vibrational product of
    modes 1333, 667.4 (x2) and 2349.1 cm-1, anchored to Q(296 K) = 286.09
    through the table's own value at 296 K."""
    B, sigma, q296 = 0.39022, 2, 286.09
    J = np.arange(max(400, int(np.ceil(183.0 / np.sqrt(B))) + 20) + 1,
                  dtype=np.float64)
    g = 2.0 * J + 1.0
    q_rot = (g[None, :] * np.exp(-C2 * B * J * (J + 1.0) / T_GRID[:, None])
             ).sum(1) / sigma
    q_vib = np.ones_like(T_GRID)
    for omega, d in ((1333.0, 1), (667.4, 2), (2349.1, 1)):
        q_vib = q_vib * (1.0 - np.exp(-C2 * omega / T_GRID)) ** (-float(d))
    model = q_rot * q_vib
    return model * (q296 / float(np.interp(T_REF, T_GRID, model)))


def ils_matrix(nu: np.ndarray, chans: np.ndarray, fwhm: float,
               cutoff_fwhm: float = 6.0) -> np.ndarray:
    """The Gaussian instrument function [n_chan, P], truncated at
    ``cutoff_fwhm`` FWHMs, each row normalised against the grid's trapezoid
    weights."""
    nu = np.asarray(nu, np.float64)
    dx = nu[None, :] - np.asarray(chans, np.float64)[:, None]
    s = fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    w = np.where(np.abs(dx) <= cutoff_fwhm * fwhm,
                 np.exp(-0.5 * (dx / s) ** 2), 0.0)
    w = w * np.gradient(nu)[None, :]
    return w / np.maximum(w.sum(axis=1, keepdims=True), 1e-300)


class Scene(NamedTuple):
    """A limb scene as the reference takes it, all host float64."""
    nu: np.ndarray            # [P] the grid [cm-1]
    nu_ref: float             # the lines' wavenumber origin [cm-1]
    lines: dict               # [L] columns, sorted by nu0
    atm: dict                 # the prior atmosphere (mars_standard's keys)
    h_t: np.ndarray           # [R] tangent heights [m]
    n_sub: int
    cutoff: float             # [cm-1]
    W: np.ndarray             # [n_chan, P] instrument function
    q: np.ndarray             # [n_T] Q(T) on T_GRID


LINE_FIELDS = ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
               "delta_air", "mass_amu")


def make_scene(grid: dict, lines: dict, atm: dict, geometry: dict,
               instrument: dict, cutoff: float, wing: float,
               grid_dtype=np.float32) -> Scene:
    """The reference scene of a configuration's sections (``grid``:
    nu_min, nu_max, n_points; ``geometry``: tangent_heights_km, n_sub;
    ``instrument``: fwhm_cm1, n_channels, chan_min, chan_max), the line
    columns ``lines`` (kept within ``wing`` of the grid, sorted) and the
    atmosphere ``atm``.  The instrument function is built on the grid as
    the configured compute dtype ``grid_dtype`` holds it."""
    nu = np.linspace(grid["nu_min"], grid["nu_max"], grid["n_points"])
    keep = ((lines["nu0"] >= grid["nu_min"] - wing)
            & (lines["nu0"] <= grid["nu_max"] + wing))
    order = np.argsort(lines["nu0"][keep], kind="stable")
    cols = {k: np.asarray(lines[k], np.float64)[keep][order]
            for k in LINE_FIELDS}
    nu_ref = float(np.round(0.5 * (cols["nu0"].min() + cols["nu0"].max())))
    chans = np.linspace(instrument["chan_min"], instrument["chan_max"],
                        instrument["n_channels"])
    W = ils_matrix(nu.astype(grid_dtype).astype(np.float64), chans,
                   instrument["fwhm_cm1"])
    return Scene(nu, nu_ref, cols, {k: np.asarray(v, np.float64)
                                    for k, v in atm.items()},
                 np.asarray(geometry["tangent_heights_km"], np.float64) * 1e3,
                 int(geometry["n_sub"]), float(cutoff), W, q_table_co2())


# ---------------------------------------------------------------------------
# Arithmetic in the chosen precision.
# ---------------------------------------------------------------------------


def _tangent(t: torch.Tensor):
    return fwAD.unpack_dual(t).tangent


def _primal(t: torch.Tensor) -> torch.Tensor:
    return fwAD.unpack_dual(t).primal


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits, round to
    nearest even); infinities and NaNs pass."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return torch.where(torch.isfinite(x), r.view(torch.float32), x)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in the inputs' promoted dtype; under "tf32" both inputs
    rounded to TF32 (a forward-mode tangent's products too) and summed in
    float32."""
    if precision != "tf32":
        return torch.matmul(a, b)
    dt = torch.promote_types(a.dtype, b.dtype)
    r = lambda v: to_tf32(v.float())
    ta, tb = _tangent(a), _tangent(b)
    pa, pb = r(_primal(a)), r(_primal(b))
    out = torch.matmul(pa, pb).to(dt)
    if ta is None and tb is None:
        return out
    t = 0.0
    if ta is not None:
        t = t + torch.matmul(r(ta), pb)
    if tb is not None:
        t = t + torch.matmul(pa, r(tb))
    return fwAD.make_dual(out, t.to(dt))


def sum_dtype(precision: str) -> torch.dtype:
    """The line sum's dtype: float32 for both precisions."""
    if precision not in PRECISIONS:
        raise ValueError(f"no precision {precision!r} ({PRECISIONS})")
    return torch.float32


# ---------------------------------------------------------------------------
# Geometry: Curtis-Godson limb paths.
# ---------------------------------------------------------------------------


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """numpy.interp (flat extension, xp ascending)."""
    i = torch.clamp(torch.searchsorted(xp, _primal(x).contiguous(),
                                       right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    f = fp[i - 1] + ((x - xp[i - 1]) / dx) * df
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class Path(NamedTuple):
    u: torch.Tensor           # [R, NL] one-side CO2 column [m^-2]
    T: torch.Tensor           # [R, NL] its Curtis-Godson temperature [K]
    p: torch.Tensor           # [R, NL] pressure [Pa]
    p_self: torch.Tensor      # [R, NL] CO2 partial pressure [Pa]
    T_air: torch.Tensor       # [R, NL] air-weighted temperature [K]
    seg_layer: torch.Tensor   # [2 NL] observer-first layer of each segment


def limb_path(scene: Scene, T_lev: torch.Tensor, vmr_lev: torch.Tensor
              ) -> Path:
    """The Curtis-Godson columns of the scene's rays through the prior
    atmosphere with temperature ``T_lev`` and CO2 VMR ``vmr_lev`` [n_lev]
    (density rehydrated at fixed pressure), ``n_sub`` equal-length samples
    a layer crossing."""
    dt, dev = T_lev.dtype, T_lev.device
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    z, p_lev = t(scene.atm["z"]), t(scene.atm["p"])
    n_lev = (p_lev / T_lev) * (1.0 / K_BOLTZ)
    r_t = MARS_RADIUS_M + t(scene.h_t)
    l_lev = torch.sqrt(torch.clamp((MARS_RADIUS_M + z) ** 2
                                   - r_t[:, None] ** 2, min=0.0))
    l_bot = l_lev[:, :-1]
    dl = l_lev[:, 1:] - l_bot
    k = (torch.arange(scene.n_sub, dtype=dt, device=dev) + 0.5) / scene.n_sub
    l_k = l_bot[..., None] + dl[..., None] * k
    z_k = torch.sqrt(r_t[:, None, None] ** 2 + l_k ** 2) - MARS_RADIUS_M
    w = torch.broadcast_to((dl / scene.n_sub)[..., None], l_k.shape)
    T = interp(z_k, z, T_lev)
    p = torch.exp(interp(z_k, z, torch.log(p_lev)))
    n = torch.exp(interp(z_k, z, torch.log(n_lev)))
    vmr = interp(z_k, z, vmr_lev)
    # Power-of-two scale: the weighted sums stay in float32's range.
    scale = 2.0 ** -83
    w_s = w * scale
    n_air = torch.sum(n * w_s, dim=-1)
    air_ok = n_air > 0
    T_air = torch.where(air_ok, torch.sum(T * n * w_s, dim=-1)
                        / torch.where(air_ok, n_air, 1.0), 200.0)
    ns = n * vmr
    u_s = torch.sum(ns * w_s, dim=-1)
    ok = u_s > 0
    u_div = torch.where(ok, u_s, 1.0)
    T_sp = torch.where(ok, torch.sum(T * ns * w_s, dim=-1) / u_div, 200.0)
    p_sp = torch.where(ok, torch.sum(p * ns * w_s, dim=-1) / u_div, 1.0)
    ps_sp = torch.where(ok, torch.sum(p * vmr * ns * w_s, dim=-1) / u_div,
                        0.0)
    NL = z.shape[0] - 1
    seg = np.concatenate([np.arange(NL)[::-1], np.arange(NL)])
    return Path(u_s * (1.0 / scale), T_sp, p_sp, ps_sp, T_air,
                torch.as_tensor(seg, device=dev))


# ---------------------------------------------------------------------------
# Line inputs of every (ray, layer) state.
# ---------------------------------------------------------------------------


class LineStates(NamedTuple):
    nu_c: torch.Tensor        # [B, L] shifted centres, offset from nu_ref
    sx: torch.Tensor          # [B, L] sqrt(ln2) / alpha_D
    y: torch.Tensor           # [B, L] sqrt(ln2) gamma_L / alpha_D
    amp: torch.Tensor         # [B, L] u S sqrt(ln2 / pi) / alpha_D [cm-1]
    live: torch.Tensor        # [B] bool: the state's column is not zero


def line_states(scene: Scene, path: Path) -> LineStates:
    """The per-(state, line) inputs of the line sum, B = rays x layers:
    strength at the state's temperature (HITRAN scaling with the table's
    Q(T)), Doppler and Lorentz widths, pressure-shifted centre.  The line
    parameters and the partition table are held in float32 (the compute
    dtype the program stages them in), the arithmetic in the state's
    dtype."""
    dt, dev = path.u.dtype, path.u.device
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    t = lambda a: f32(a).to(dt)
    ln = scene.lines
    R, NL = path.u.shape
    T = path.T.reshape(R * NL, 1)
    p_atm = path.p.reshape(R * NL, 1) / ATM
    ps_atm = path.p_self.reshape(R * NL, 1) / ATM
    u_cm2 = path.u.reshape(R * NL, 1) * 1.0e-4
    nu0_off = t(ln["nu0"] - scene.nu_ref)
    nu0_abs = (f32(ln["nu0"] - scene.nu_ref) + f32(scene.nu_ref)).to(dt)
    # Q(T_ref) / Q(T) by linear interpolation in the table (clamped).
    tg, q = t(T_GRID), t(scene.q)
    f = torch.clamp((T - tg[0]) / (tg[1] - tg[0]), 0.0, tg.shape[0] - 1.000001)
    i0 = torch.floor(_primal(f)).to(torch.int64)
    frac = f - i0
    qT = q[i0] * (1 - frac) + q[i0 + 1] * frac
    f_ref = (T_REF - tg[0]) / (tg[1] - tg[0])
    i_ref = int(torch.floor(f_ref))
    fr_ref = f_ref - i_ref
    q_ref = q[i_ref] * (1 - fr_ref) + q[i_ref + 1] * fr_ref
    S = (t(ln["sw"]) * (q_ref / qT)
         * torch.exp(-C2 * t(ln["elower"]) * (1.0 / T - 1.0 / T_REF))
         * (1.0 - torch.exp(-C2 * nu0_abs / T))
         / (1.0 - torch.exp(-C2 * nu0_abs / T_REF)))
    alpha_d = nu0_abs / C_LIGHT * torch.sqrt(
        2.0 * LN2 * K_BOLTZ * T / (t(ln["mass_amu"]) * AMU))
    gamma_l = (T_REF / T) ** t(ln["n_air"]) * (
        t(ln["gamma_air"]) * (p_atm - ps_atm) + t(ln["gamma_self"]) * ps_atm)
    nu_c = nu0_off + t(ln["delta_air"]) * p_atm
    inv_ad = 1.0 / alpha_d
    return LineStates(nu_c, SQRT_LN2 * inv_ad, SQRT_LN2 * gamma_l * inv_ad,
                      u_cm2 * S * (SQRT_LN2_PI * inv_ad),
                      (_primal(path.u).reshape(-1) > 0))


# ---------------------------------------------------------------------------
# Humlicek w4 and the line sum.
# ---------------------------------------------------------------------------


def _cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _cinv(b):
    inv = 1.0 / (b[0] * b[0] + b[1] * b[1])
    return (b[0] * inv, -b[1] * inv)


def _cpoly(coeffs, z):
    pr = torch.zeros_like(z[0]) + coeffs[0]
    pi = torch.zeros_like(z[0])
    for c in coeffs[1:]:
        pr, pi = pr * z[0] - pi * z[1] + c, pr * z[1] + pi * z[0]
    return (pr, pi)


def voigt_region1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Re w by region I of w4: (t / sqrt(pi)) / (0.5 + t^2), t = y - i x."""
    t = (y, -x)
    w = _cmul(t, _cinv(_cadd_re(0.5, _cmul(t, t))))
    return INV_SQRT_PI * w[0]


def _cadd_re(s, a):
    return (s + a[0], a[1])


def voigt_near(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Re w by regions I to IV of w4, each pair the region that |x| + y
    and y against 0.195 |x| - 0.176 select."""
    t = (y, -x)
    s = torch.abs(x) + y
    u = _cmul(t, t)
    w1 = _cmul((INV_SQRT_PI * t[0], INV_SQRT_PI * t[1]),
               _cinv(_cadd_re(0.5, u)))
    num2 = _cmul(t, _cadd_re(1.410474, (INV_SQRT_PI * u[0],
                                        INV_SQRT_PI * u[1])))
    den2 = _cadd_re(0.75, _cmul(u, _cadd_re(3.0, u)))
    w2 = _cmul(num2, _cinv(den2))
    w3 = _cmul(_cpoly(_N3, t), _cinv(_cpoly(_D3, t)))
    in4 = (s < 5.5) & (y < 0.195 * torch.abs(x) - 0.176)
    t4 = (torch.where(in4, y, 0.0), -torch.where(in4, x, 0.0))
    u4 = _cmul(t4, t4)
    frac4 = _cmul(_cpoly(_P4, u4), _cinv(_cpoly(_Q4, u4)))
    e = torch.exp(u4[0])
    w4r = e * torch.cos(u4[1]) - _cmul(t4, frac4)[0]
    return torch.where(s >= 15.0, w1[0], torch.where(
        s >= 5.5, w2[0], torch.where(in4, w4r, w3[0])))


def line_sum(scene: Scene, ls: LineStates, precision: str) -> torch.Tensor:
    """Optical depth [B, P] of every state in the line sum's dtype: sum
    over the lines within the cutoff of amp x Re w(x, y), x = sx (nu -
    nu_c); 0 for dead states."""
    dt, dev = sum_dtype(precision), ls.amp.device
    ls = ls._replace(nu_c=ls.nu_c.to(dt), sx=ls.sx.to(dt), y=ls.y.to(dt),
                     amp=ls.amp.to(dt))
    nu_off = torch.as_tensor(scene.nu - scene.nu_ref, dtype=dt, device=dev)
    centres = scene.lines["nu0"] - scene.nu_ref
    # Pressure shifts move a centre by < 0.01 cm-1 on Mars: 1 cm-1 of room.
    reach = scene.cutoff + 1.0
    live = torch.nonzero(ls.live)[:, 0]
    cols = []
    for p0 in range(0, nu_off.shape[0], POINTS_PER_BLOCK):
        p1 = min(p0 + POINTS_PER_BLOCK, nu_off.shape[0])
        l0 = int(np.searchsorted(centres, scene.nu[p0] - scene.nu_ref - reach))
        l1 = int(np.searchsorted(centres, scene.nu[p1 - 1] - scene.nu_ref
                                 + reach, side="right"))
        nu_b = nu_off[p0:p1]
        group = max(1, PAIRS_PER_SLAB // max(1, (l1 - l0) * (p1 - p0)))
        parts = []
        for g in live.split(group):
            if l1 == l0:
                parts.append(torch.zeros(g.shape[0], p1 - p0, dtype=dt,
                                         device=dev))
                continue
            sl = slice(l0, l1)
            dnu = nu_b[None, None, :] - ls.nu_c[g, sl][:, :, None]
            x = ls.sx[g, sl][:, :, None] * dnu
            y = torch.broadcast_to(ls.y[g, sl][:, :, None], x.shape)
            inside = torch.abs(_primal(dnu)) <= scene.cutoff
            s = torch.abs(_primal(x)) + _primal(y)
            far = s >= 15.0
            # Region I's inputs clamped away from its pole where another
            # region takes the pair.
            K = voigt_region1(torch.where(far, x, 100.0), y)
            near = torch.nonzero((~far & inside).reshape(-1))[:, 0]
            if near.numel():
                Kn = voigt_near(x.reshape(-1)[near], y.reshape(-1)[near])
                K = K.reshape(-1).scatter(0, near, Kn).reshape(K.shape)
            K = torch.where(inside, K, 0.0)
            parts.append(matmul(ls.amp[g, sl][:, None, :], K,
                                precision)[:, 0, :])
        cols.append(torch.cat(parts, 0))
    tau_live = torch.cat(cols, 1)
    B = ls.live.shape[0]
    return torch.zeros(B, nu_off.shape[0], dtype=dt, device=dev).index_copy(
        0, live, tau_live)


def radiance(scene: Scene, path: Path, dtau: torch.Tensor,
             precision: str) -> torch.Tensor:
    """The observed spectra y [R x n_chan] of depths ``dtau`` [R, NL, P]:
    Planck sources at the air temperature (on the grid in the line sum's
    dtype), segment sums in observer-first order (deep space behind), then
    the instrument function (in the line sum's dtype), each product in the
    promoted dtype of its factors."""
    dt, dev = dtau.dtype, dtau.device
    nu = torch.as_tensor(scene.nu, dtype=dt, device=dev)
    B = C1B * nu ** 3 / torch.expm1(C2 * nu / path.T_air[:, :, None])
    c = torch.cumsum(dtau.index_select(-2, path.seg_layer), dim=-2)
    t_after = torch.exp(-c)
    t_before = torch.cat([torch.ones_like(t_after[..., :1, :]),
                          t_after[..., :-1, :]], dim=-2)
    w_layer = torch.zeros_like(dtau).index_add(
        1, path.seg_layer, t_before - t_after)
    I = torch.sum(B * w_layer, dim=-2)
    W = torch.as_tensor(scene.W, dtype=dt, device=dev).to(I.dtype)
    return matmul(I, W.T, precision).reshape(-1)


def forward(scene: Scene, T_lev, vmr_lev, precision: str = "float32",
            device="cpu", state_dtype=torch.float32) -> torch.Tensor:
    """y [R x n_chan] at temperature ``T_lev`` and CO2 VMR ``vmr_lev``
    [n_lev] (tensors or arrays, held in ``state_dtype``; forward-mode duals
    pass through)."""
    dt = state_dtype
    t = lambda a: (a.to(dt) if isinstance(a, torch.Tensor) else
                   torch.as_tensor(np.asarray(a), dtype=dt, device=device))
    path = limb_path(scene, t(T_lev), t(vmr_lev))
    ls = line_states(scene, path)
    R, NL = path.u.shape
    dtau = line_sum(scene, ls, precision).reshape(R, NL, -1)
    return radiance(scene, path, dtau, precision)


def jvp(scene: Scene, T_lev, vmr_lev, dT, dvmr, precision: str = "float32",
        device="cpu", state_dtype=torch.float32) -> tuple:
    """(y, dy): the spectra and their derivative along (dT, dvmr) by
    forward-mode AD through the same computation."""
    dt = state_dtype
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    with fwAD.dual_level():
        T = fwAD.make_dual(t(T_lev), t(dT))
        v = fwAD.make_dual(t(vmr_lev), t(dvmr))
        y = forward(scene, T, v, precision, device, state_dtype)
        out = fwAD.unpack_dual(y)
        tangent = (out.tangent if out.tangent is not None
                   else torch.zeros_like(out.primal))
        return out.primal.clone(), tangent.clone()


def required_work(scene: Scene, T_lev, vmr_lev, device="cpu") -> tuple:
    """The line-sum inputs a state requires, as the yardstick counts them:
    (nu [P], nu_c, sx, y [B, L], live [B]) in float64 on ``device``, the
    grid in the lines' offset coordinates."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                  device=device)
    ls = line_states(scene, limb_path(scene, t(T_lev), t(vmr_lev)))
    nu = torch.as_tensor(scene.nu - scene.nu_ref, dtype=torch.float64,
                         device=device)
    return nu, ls.nu_c, ls.sx, ls.y, ls.live


# ---------------------------------------------------------------------------
# The scene a configuration describes.  A configuration's ``[bench]`` table
# names its reference module (``reference = "physics"``); the harness takes
# from it the run's inputs (``inputs``), the check that the reference
# covers the configuration (``covers``), the scene (``configured_scene``),
# its prior (``prior``), and ``forward``, ``jvp`` and ``required_work``
# above.
# ---------------------------------------------------------------------------

# The mass of 12C16O2 [amu] (AME2020 atomic masses).
CO2_MASS_AMU = 43.98982924


def random_lines(n: int, nu_min: float, nu_max: float,
                 g: np.random.Generator) -> dict:
    """A random CO2 band (the reference bench's recipe): uniform centres,
    log-uniform strengths 1e-24 to 1e-18, uniform widths, temperature
    exponents, lower-state energies and shifts."""
    return {
        "nu0": g.uniform(nu_min, nu_max, n),
        "sw": 10.0 ** g.uniform(-24.0, -18.0, n),
        "a_einstein": np.ones(n),
        "gamma_air": g.uniform(0.04, 0.1, n),
        "gamma_self": g.uniform(0.05, 0.12, n),
        "elower": g.uniform(0.0, 3000.0, n),
        "n_air": g.uniform(0.5, 0.8, n),
        "delta_air": g.uniform(-0.01, 0.002, n),
        "gp": np.ones(n),
        "gpp": np.ones(n),
        "mass_amu": np.full(n, CO2_MASS_AMU),
        "mol_id": np.full(n, 2, dtype=np.int32),
        "iso_id": np.full(n, 1, dtype=np.int32),
    }


def inputs(cfg, bench: dict) -> tuple:
    """(lines, atm): the configuration's line list, ``[bench.lines]``'s
    recipe drawn from the seed it fixes (a deployment reads one catalog),
    and its atmosphere (``[bench] atmosphere``), as the program reads them
    from files."""
    spec = bench["lines"]
    if spec["recipe"] != "random_lines":
        raise ValueError(f"no line recipe {spec['recipe']!r}")
    lines = random_lines(int(spec["n_lines"]), spec["nu_min"],
                         spec["nu_max"],
                         np.random.default_rng(int(spec["seed"])))
    if bench["atmosphere"] != "mars_standard":
        raise ValueError(f"no atmosphere {bench['atmosphere']!r}")
    return lines, mars_standard(cfg.scene.n_levels, cfg.scene.z_top_m)


def covers(cfg) -> None:
    """Raise unless this reference covers the configuration: an LTE CO2
    limb scan through a Gaussian instrument function, no continuum, no
    field of view, no table, humlicek4."""
    bad = []
    if cfg.geometry.mode != "limb":
        bad.append("geometry.mode")
    if cfg.nlte.enabled or cfg.cia.enabled or cfg.lines.chi:
        bad.append("nlte/cia/chi")
    if cfg.instrument.fov_fwhm_km > 0 or not cfg.instrument.enabled:
        bad.append("instrument")
    if cfg.compute.use_lut or cfg.compute.variant != "humlicek4":
        bad.append("compute")
    if tuple(cfg.scene.species) != ("CO2",):
        bad.append("scene.species")
    if bad:
        raise ValueError(f"the plain reference does not cover {bad}")


def configured_scene(cfg, lines: dict, atm: dict) -> Scene:
    """The reference scene of the program's configuration ``cfg`` on the
    line list and atmosphere :func:`inputs` made."""
    ins = cfg.instrument
    return make_scene(
        {"nu_min": cfg.grid.nu_min, "nu_max": cfg.grid.nu_max,
         "n_points": cfg.grid.n_points},
        lines, atm,
        {"tangent_heights_km": cfg.geometry.tangent_heights_km,
         "n_sub": cfg.geometry.n_sub},
        {"fwhm_cm1": ins.fwhm_cm1, "n_channels": ins.n_channels,
         "chan_min": ins.chan_min, "chan_max": ins.chan_max},
        cfg.compute.cutoff_cm1, cfg.lines.wing_cm1,
        grid_dtype=np.float64 if cfg.compute.dtype == "float64"
        else np.float32)


def prior(scene: Scene) -> dict:
    """The scene's prior state: altitudes z [m], temperature T [K] and the
    VMR vmr of the species the states perturb, [n_lev] each."""
    return {"z": scene.atm["z"], "T": scene.atm["T"],
            "vmr": scene.atm["vmr_CO2"]}
