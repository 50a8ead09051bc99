"""Humlicek w4 Faddeeva evaluator (port of
``spectrobot_tpu.ops.voigt.wofz_humlicek4``).

Conventions: w(z) = exp(-z^2) erfc(-iz), z = x + i y with y >= 0.  All four
region formulas are evaluated on masked-safe inputs and combined with
``torch.where`` (the plain version); the CUDA kernel
(``csrc/opacity_batch.cu``) evaluates the same formulas with a branch per
pair instead.
"""

from __future__ import annotations

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
