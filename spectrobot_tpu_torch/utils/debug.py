"""Numerical-safety helpers (port of ``spectrobot_tpu.utils.debug``).

``checked(fn)`` wraps a function so that a call returns (error, out), and
``error.throw()`` raises when ``fn`` raised or its output holds a
non-finite value (the reference's ``jax.experimental.checkify`` wrapper;
here the check is on the output, after the call).  ``assert_finite``
prints a warning naming a tensor that holds a non-finite value and passes
the tensor through.  No production path calls either.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


class CheckError:
    """The outcome of a :func:`checked` call: ``get()`` is the message, or
    None when the call was clean; ``throw()`` raises it."""

    def __init__(self, message: Optional[str] = None):
        self.message = message

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def _tensors(out) -> list:
    """The tensors of a (nested) tuple, list or dict output."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def checked(fn: Callable) -> Callable:
    """``fn`` wrapped: g(*a, **k) -> (error, out), out None when ``fn``
    raised; ``error.throw()`` raises a FloatingPointError naming what went
    wrong (an exception of ``fn``, or a non-finite value in the tensors of
    its output)."""
    name = getattr(fn, "__name__", repr(fn))

    def g(*args, **kwargs):
        try:
            out = fn(*args, **kwargs)
        except Exception as e:          # reported through the error
            return CheckError(f"{name} raised {type(e).__name__}: {e}"), None
        bad = [i for i, t in enumerate(_tensors(out))
               if t.is_floating_point() and not bool(torch.isfinite(t).all())]
        msg = (f"non-finite values in output tensor(s) {bad} of {name}"
               if bad else None)
        return CheckError(msg), out

    return g


def assert_finite(name: str, x: torch.Tensor) -> torch.Tensor:
    """Print the reference's warning when ``x`` holds a non-finite value,
    and return ``x``.  Inside ``torch.func.vmap`` the values cannot be
    read, and nothing is checked."""
    try:
        bad = not bool(torch.isfinite(x).all())
    except RuntimeError:                # a vmap-batched tensor
        return x
    if bad:
        print(f"[spectrobot_tpu] NON-FINITE values in {name}")
    return x
