"""Real-pair complex arithmetic helpers (port of ``spectrobot_tpu.ops.cpx``).

Complex numbers are (re, im) tuples of real tensors, so the same line-shape
math reads like the reference and like the CUDA kernel, which has no complex
type either.  Python floats mix in as scalars.
"""

from typing import Tuple

import torch

C = Tuple  # (re, im)


def cadd(a: C, b: C) -> C:
    return (a[0] + b[0], a[1] + b[1])


def csub(a: C, b: C) -> C:
    return (a[0] - b[0], a[1] - b[1])


def cmul(a: C, b: C) -> C:
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def cscale(s, a: C) -> C:
    return (s * a[0], s * a[1])


def cadd_re(s, a: C) -> C:
    return (s + a[0], a[1])


def cinv(b: C) -> C:
    d = b[0] * b[0] + b[1] * b[1]
    inv = 1.0 / d
    return (b[0] * inv, -b[1] * inv)


def cexp(a: C) -> C:
    r = torch.exp(a[0])
    return (r * torch.cos(a[1]), r * torch.sin(a[1]))


def cpolyval_real_coeffs(coeffs, z: C) -> C:
    """Horner evaluation of a polynomial with REAL coefficients (python
    floats, highest degree first) at complex z."""
    pr = torch.zeros_like(z[0]) + coeffs[0]
    pi = torch.zeros_like(z[0])
    for c in coeffs[1:]:
        pr, pi = pr * z[0] - pi * z[1] + c, pr * z[1] + pi * z[0]
    return (pr, pi)
