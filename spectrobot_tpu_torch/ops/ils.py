"""Instrument line shape (port of ``spectrobot_tpu.ops.ils``: the host
channelisation matrix and its application).

``ils_matrix`` builds, host-side in float64 numpy, a dense matrix W
[n_chan, P] whose rows are area-normalised ILS kernels centred on each
channel; ``apply_ils`` is one matrix product I_chan = I_mono @ W.T, left to
``torch.matmul`` as the reference leaves it to XLA.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _gaussian(dx: np.ndarray, fwhm: float) -> np.ndarray:
    s = fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    return np.exp(-0.5 * (dx / s) ** 2)


def _triangle(dx: np.ndarray, fwhm: float) -> np.ndarray:
    return np.maximum(1.0 - np.abs(dx) / fwhm, 0.0)


def _sinc(dx: np.ndarray, fwhm: float) -> np.ndarray:
    # Unapodised FTS response; np.sinc(a x) halves at a|x| ~ 0.6034.
    return np.sinc(1.2067 / fwhm * dx)


def _sinc2(dx: np.ndarray, fwhm: float) -> np.ndarray:
    # Apodised response; sinc^2(a x) has FWHM ~ 0.8859 / a.
    return np.sinc(0.8859 / fwhm * dx) ** 2


_SHAPES: dict = {"gaussian": _gaussian, "triangle": _triangle,
                 "sinc": _sinc, "sinc2": _sinc2}


def ils_matrix(nu_grid: np.ndarray, nu_channels: np.ndarray, fwhm: float,
               shape: str = "gaussian", cutoff_fwhm: float = 6.0
               ) -> np.ndarray:
    """Dense channelisation matrix W [n_chan, P] (host-side, float64).

    Rows are the ILS centred on each channel, truncated at ``cutoff_fwhm``
    FWHMs and normalised against the fine grid's trapezoid weights, so a
    flat spectrum maps to a flat channel vector even near grid edges.
    """
    nu_grid = np.asarray(nu_grid, dtype=np.float64)
    nu_channels = np.asarray(nu_channels, dtype=np.float64)
    fn: Callable = _SHAPES[shape]
    dx = nu_grid[None, :] - nu_channels[:, None]          # [C, P]
    w = fn(dx, fwhm)
    w = np.where(np.abs(dx) <= cutoff_fwhm * fwhm, w, 0.0)
    w = w * np.gradient(nu_grid)[None, :]
    norm = w.sum(axis=1, keepdims=True)
    return w / np.maximum(norm, 1e-300)


def apply_ils(spectra: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """I_chan = spectra @ W.T over any leading axes, in the promoted dtype
    of the two (full float32 on the card: TF32 is switched off at the
    entry points)."""
    dt = torch.promote_types(spectra.dtype, W.dtype)
    return torch.matmul(spectra.to(dt), W.to(dt).T)
