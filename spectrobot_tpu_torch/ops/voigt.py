"""Faddeeva evaluators (port of ``spectrobot_tpu.ops.voigt``): Humlicek's
w4 and Weideman's rational approximation, and the area-normalised Voigt
profile.

Conventions: w(z) = exp(-z^2) erfc(-iz), z = x + i y with y >= 0.

* :func:`wofz_humlicek4`: all four region formulas evaluated on
  masked-safe inputs and combined with ``torch.where`` (the plain
  version); the CUDA kernels (``csrc/voigt_primal.cuh``) evaluate the same
  formulas with a branch per pair instead.
* :func:`wofz_weideman`: one formula, no regions (Weideman 1994, N = 32
  terms): about 1e-6 relative and 1.1e-13 absolute in float64, but not
  wing-safe in float32.  The reference runs it only on its XLA engine, so
  the port runs it in plain PyTorch on any device (``ops.cuda_basis.
  WEIDEMAN``); no kernel evaluates it.

The area-normalised Voigt profile is
  V(nu) = sqrt(ln2/pi) / alpha_D * Re w(x + i y),
  x = sqrt(ln2) (nu - nu0') / alpha_D,  y = sqrt(ln2) gamma_L / alpha_D.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from spectrobot_tpu_torch.constants import INV_SQRT_PI
from spectrobot_tpu_torch.ops import cpx

# Humlicek region-3/4 rational coefficients, highest degree first (the
# reference's _N3/_D3/_P4/_Q4; the CUDA kernel carries the same numbers).
_N3 = (0.5642236, 3.778987, 11.96482, 20.20933, 16.4955)
_D3 = (1.0, 6.699398, 21.69274, 39.27121, 38.82363, 16.4955)
_P4 = (0.56419, -1.320522, 35.76683, -219.0313, 1540.787, -3321.9905,
       36183.31)
_Q4 = (-1.0, 1.841439, -61.57037, 364.2191, -2186.181, 9022.228, -24322.84,
       32066.6)


def wofz_humlicek4(x, y, *, with_region4: bool = True):
    """Re and Im of w(x+iy) via Humlicek's (1982) w4, branchless.

    Regions by s = |x| + y: I s >= 15; II 5.5 <= s < 15; III s < 5.5 and
    y >= 0.195|x| - 0.176; IV otherwise.  ``with_region4=False`` skips
    region IV; valid when the caller proves no pair is in it (any block with
    min(y) >= 0.8965 qualifies).
    """
    t = (y, -x)              # t = y - i x
    s = torch.abs(x) + y
    in12 = s >= 5.5
    in1 = s >= 15.0

    u = cpx.cmul(t, t)
    w1 = cpx.cmul(cpx.cscale(INV_SQRT_PI, t), cpx.cinv(cpx.cadd_re(0.5, u)))

    num2 = cpx.cmul(t, cpx.cadd_re(1.410474, cpx.cscale(INV_SQRT_PI, u)))
    den2 = cpx.cadd_re(0.75, cpx.cmul(u, cpx.cadd_re(3.0, u)))
    w2 = cpx.cmul(num2, cpx.cinv(den2))

    w3 = cpx.cmul(cpx.cpolyval_real_coeffs(_N3, t),
                  cpx.cinv(cpx.cpolyval_real_coeffs(_D3, t)))

    if not with_region4:
        wr = torch.where(in1, w1[0], torch.where(in12, w2[0], w3[0]))
        wi = torch.where(in1, w1[1], torch.where(in12, w2[1], w3[1]))
        return (wr, wi)

    # Region IV: w = exp(u) - t P(u)/Q(u); inputs outside the region are
    # clamped to 0 so exp stays finite there.
    in4 = torch.logical_and(~in12, y < 0.195 * torch.abs(x) - 0.176)
    xr4 = torch.where(in4, x, 0.0)
    yr4 = torch.where(in4, y, 0.0)
    t4 = (yr4, -xr4)
    u4 = cpx.cmul(t4, t4)
    frac4 = cpx.cmul(cpx.cpolyval_real_coeffs(_P4, u4),
                     cpx.cinv(cpx.cpolyval_real_coeffs(_Q4, u4)))
    w4 = cpx.csub(cpx.cexp(u4), cpx.cmul(t4, frac4))

    wr = torch.where(in1, w1[0], torch.where(
        in12, w2[0], torch.where(in4, w4[0], w3[0])))
    wi = torch.where(in1, w1[1], torch.where(
        in12, w2[1], torch.where(in4, w4[1], w3[1])))
    return (wr, wi)


def _poly_deriv(coeffs):
    """Coefficients (highest degree first) of the derivative polynomial."""
    n = len(coeffs)
    return tuple(c * (n - 1 - j) for j, c in enumerate(coeffs[:-1]))


# Region II derivative numerator Nd(u) = -c u^3 + 3(c-a) u^2
# + (2.25c - 3a) u + 0.75a, with a = 1.410474 and c = 1/sqrt(pi).
_A2 = 1.410474
_ND2 = (-INV_SQRT_PI, 3.0 * (INV_SQRT_PI - _A2),
        2.25 * INV_SQRT_PI - 3.0 * _A2, 0.75 * _A2)


def wofz_humlicek4_grad(x, y, *, with_region4: bool = True):
    """w(x+iy) and the partials of K = Re w, differentiating each Humlicek
    w4 region formula in closed form (the derivative the primal actually
    has, so Jacobians match finite differences of the forward).

    Returns (wr, wi, dK_dx, dK_dy).  With t = y - i x, w = f(t),
    dK/dx = Im f'(t) and dK/dy = Re f'(t); u = t^2:

      I  : f' = c (0.5 - u) / (0.5 + u)^2
      II : f' = Nd(u) / D(u)^2,  D = 0.75 + u (3 + u)
      III: f' = N3'/D3 - (N3/D3)(D3'/D3)
      IV : f' = 2t e^u - F - 2u F',  F = P4/Q4,  F' = P4'/Q4 - F Q4'/Q4

    Every division is staged through ``cpx.cinv`` (the largest intermediate
    is |denominator|^2, about x^4 in the far wing: float32-safe).  The exact
    identity w' = -2zw + 2i/sqrt(pi) is not used: its real part cancels to
    about eight digits in deep wings.
    """
    c = INV_SQRT_PI
    t = (y, -x)
    s = torch.abs(x) + y
    in12 = s >= 5.5
    in1 = s >= 15.0

    u = cpx.cmul(t, t)

    inv1 = cpx.cinv(cpx.cadd_re(0.5, u))
    w1 = cpx.cmul(cpx.cscale(c, t), inv1)
    g1 = cpx.cmul(cpx.cscale(c, (0.5 - u[0], -u[1])), cpx.cmul(inv1, inv1))

    num2 = cpx.cmul(t, cpx.cadd_re(_A2, cpx.cscale(c, u)))
    inv2 = cpx.cinv(cpx.cadd_re(0.75, cpx.cmul(u, cpx.cadd_re(3.0, u))))
    w2 = cpx.cmul(num2, inv2)
    g2 = cpx.cmul(cpx.cmul(cpx.cpolyval_real_coeffs(_ND2, u), inv2), inv2)

    invD3 = cpx.cinv(cpx.cpolyval_real_coeffs(_D3, t))
    w3 = cpx.cmul(cpx.cpolyval_real_coeffs(_N3, t), invD3)
    g3 = cpx.csub(
        cpx.cmul(cpx.cpolyval_real_coeffs(_poly_deriv(_N3), t), invD3),
        cpx.cmul(w3, cpx.cmul(cpx.cpolyval_real_coeffs(_poly_deriv(_D3), t),
                              invD3)))

    if not with_region4:
        def sel(v1, v2, v3):
            return torch.where(in1, v1, torch.where(in12, v2, v3))
        return (sel(w1[0], w2[0], w3[0]), sel(w1[1], w2[1], w3[1]),
                sel(g1[1], g2[1], g3[1]), sel(g1[0], g2[0], g3[0]))

    in4 = torch.logical_and(~in12, y < 0.195 * torch.abs(x) - 0.176)
    t4 = (torch.where(in4, y, 0.0), -torch.where(in4, x, 0.0))
    u4 = cpx.cmul(t4, t4)
    invQ = cpx.cinv(cpx.cpolyval_real_coeffs(_Q4, u4))
    F = cpx.cmul(cpx.cpolyval_real_coeffs(_P4, u4), invQ)
    eu = cpx.cexp(u4)
    w4 = cpx.csub(eu, cpx.cmul(t4, F))
    dF = cpx.csub(
        cpx.cmul(cpx.cpolyval_real_coeffs(_poly_deriv(_P4), u4), invQ),
        cpx.cmul(F, cpx.cmul(cpx.cpolyval_real_coeffs(_poly_deriv(_Q4), u4),
                             invQ)))
    g4 = cpx.csub(cpx.cscale(2.0, cpx.cmul(t4, eu)),
                  cpx.cadd(F, cpx.cscale(2.0, cpx.cmul(u4, dF))))

    def sel(v1, v2, v3, v4):
        return torch.where(in1, v1, torch.where(
            in12, v2, torch.where(in4, v4, v3)))
    return (sel(w1[0], w2[0], w3[0], w4[0]), sel(w1[1], w2[1], w3[1], w4[1]),
            sel(g1[1], g2[1], g3[1], g4[1]), sel(g1[0], g2[0], g3[0], g4[0]))


# ---------------------------------------------------------------------------
# Weideman rational approximation
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def weideman_coeffs(n_terms: int) -> Tuple[float, Tuple[float, ...]]:
    """Real polynomial coefficients of Weideman's rational approximation,
    computed once on the host in float64 (the FFT of the Gaussian sampled
    at tangent nodes, Weideman 1994).  Returns (L, coefficients highest
    degree first).  A copy of the reference's, bit for bit."""
    N = n_terms
    M = 2 * N
    M2 = 2 * M
    k = np.arange(-M + 1, M)
    L = np.sqrt(N / np.sqrt(2.0))
    theta = k * np.pi / M
    t = L * np.tan(theta / 2.0)
    f = np.exp(-t ** 2) * (L ** 2 + t ** 2)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / M2
    a = a[1 : N + 1][::-1]  # highest degree first for Horner
    return float(L), tuple(float(c) for c in a)


def _moebius(x, y, L: float):
    """D = 1/(L - iz) and Z = (L + iz) D, with iz = -y + i x."""
    D = cpx.cinv((L + y, -x))
    return D, cpx.cmul((L - y, x), D)


def wofz_weideman(x, y, n_terms: int = 32):
    """Re and Im of w(x+iy) by the Weideman rational approximation, y >= 0:
    one Moebius transform, one real-coefficient Horner chain of
    ``n_terms`` steps, w = 2 p(Z) D^2 + D / sqrt(pi)."""
    L, coeffs = weideman_coeffs(n_terms)
    D, Z = _moebius(x, y, L)
    p = cpx.cpolyval_real_coeffs(coeffs, Z)
    del Z
    return cpx.cadd(cpx.cscale(2.0, cpx.cmul(p, cpx.cmul(D, D))),
                    cpx.cscale(INV_SQRT_PI, D))


def wofz_weideman_grad(x, y, n_terms: int = 32):
    """w(z) and the partials of K = Re w(x+iy), differentiating the
    Weideman approximant in closed form (a second Horner chain, p', on the
    same Moebius transform).  Returns (wr, wi, dK_dx, dK_dy).

        w  = 2 p(Z) D^2 + D / sqrt(pi),   D = 1/(L - iz),  Z = (L + iz) D
        w' = i g,   g = 4 L p'(Z) D^4 + 4 p(Z) D^3 + D^2 / sqrt(pi)
        dK/dx = -Im g,   dK/dy = -Re g.

    Every term carries the same decay of D, so nothing cancels in the far
    wing; the identity w' = -2 z w + 2i/sqrt(pi) is not used, since its
    real part cancels to about eight digits there in float32."""
    L, coeffs = weideman_coeffs(n_terms)
    n = len(coeffs)
    dcoeffs = tuple(c * (n - 1 - j) for j, c in enumerate(coeffs[:-1]))
    D, Z = _moebius(x, y, L)
    p = cpx.cpolyval_real_coeffs(coeffs, Z)
    dp = cpx.cpolyval_real_coeffs(dcoeffs, Z)
    del Z
    D2 = cpx.cmul(D, D)
    w = cpx.cadd(cpx.cscale(2.0, cpx.cmul(p, D2)), cpx.cscale(INV_SQRT_PI, D))
    D3 = cpx.cmul(D2, D)
    del D
    # The reference's order of the sum: (4L p' D^4 + 4 p D^3) + D^2/sqrt(pi).
    g = cpx.cscale(4.0 * L, cpx.cmul(dp, cpx.cmul(D2, D2)))
    del dp
    g = cpx.cadd(g, cpx.cscale(4.0, cpx.cmul(p, D3)))
    del p, D3
    g = cpx.cadd(g, cpx.cscale(INV_SQRT_PI, D2))
    return w[0], w[1], -g[1], -g[0]


def voigt_profile(dnu, alpha_d, gamma_l, variant: str = "weideman",
                  n_terms: int = 32):
    """Area-normalised Voigt profile V(dnu) [1/cm^-1]: dnu = nu - nu0'
    (shift applied), alpha_d the Doppler and gamma_l the Lorentz HWHM
    [cm-1]; tensors broadcast."""
    sqrt_ln2 = math.sqrt(math.log(2.0))
    sqrt_ln2_pi = math.sqrt(math.log(2.0) / math.pi)
    inv_ad = 1.0 / alpha_d
    x = sqrt_ln2 * dnu * inv_ad
    y = sqrt_ln2 * gamma_l * inv_ad
    # Broadcast tensors of the arguments' dtype and device: a Python width
    # is a scalar.
    ref = x if isinstance(x, torch.Tensor) else torch.as_tensor(y)
    dt = torch.result_type(x, y)
    x, y = torch.broadcast_tensors(*(torch.as_tensor(
        a, dtype=dt, device=ref.device) for a in (x, y)))
    if variant == "weideman":
        wr, _ = wofz_weideman(x, y, n_terms=n_terms)
    elif variant == "humlicek4":
        wr, _ = wofz_humlicek4(x, y)
    else:
        raise ValueError(f"unknown voigt variant {variant!r}")
    return sqrt_ln2_pi * inv_ad * wr
