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

from spectrobot_tpu.constants import INV_SQRT_PI
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
