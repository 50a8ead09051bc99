"""Optional matplotlib figures (SURVEY.md section 6: the reference's outputs
were prints + matplotlib figures; these round out the migration story).

All functions take file paths and save PNGs — headless-safe (Agg backend),
no display required.  matplotlib is imported lazily so the compute stack
never depends on it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_radiances(path: str, nu: np.ndarray, radiance: np.ndarray,
                   labels: Optional[Sequence[str]] = None,
                   title: str = "Limb radiances") -> str:
    """radiance: [n_ray, P]; one curve per ray."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 4.5))
    R = radiance.shape[0]
    for r in range(R):
        lab = labels[r] if labels is not None else None
        ax.plot(nu, radiance[r], lw=0.7, label=lab)
    ax.set_xlabel("wavenumber [cm$^{-1}$]")
    ax.set_ylabel("radiance [W m$^{-2}$ sr$^{-1}$ (cm$^{-1}$)$^{-1}$]")
    ax.set_title(title)
    if labels is not None and R <= 12:
        ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def plot_retrieval(path: str, z_m: np.ndarray, T_retrieved: np.ndarray,
                   T_prior: np.ndarray, T_sigma: Optional[np.ndarray] = None,
                   T_true: Optional[np.ndarray] = None) -> str:
    """Temperature-profile retrieval summary (prior / retrieved / truth)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 6))
    km = z_m / 1e3
    ax.plot(T_prior, km, "--", color="gray", label="prior")
    ax.plot(T_retrieved, km, color="C0", label="retrieved")
    if T_sigma is not None:
        ax.fill_betweenx(km, T_retrieved - T_sigma, T_retrieved + T_sigma,
                         color="C0", alpha=0.2, lw=0)
    if T_true is not None:
        ax.plot(T_true, km, color="C3", label="truth")
    ax.set_xlabel("temperature [K]")
    ax.set_ylabel("altitude [km]")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def plot_averaging_kernels(path: str, z_m: np.ndarray,
                           A_kernel: np.ndarray, n_T: int) -> str:
    """Temperature-block averaging-kernel rows vs altitude."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 6))
    km = z_m / 1e3
    A_T = A_kernel[:n_T, :n_T]
    for i in range(n_T):
        ax.plot(A_T[i], km, lw=0.8)
    ax.plot(A_T.sum(axis=1), km, "k--", lw=1.5, label="row sum")
    ax.set_xlabel("averaging kernel")
    ax.set_ylabel("altitude [km]")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def plot_fit(path: str, chans: np.ndarray, y_obs: np.ndarray,
             y_fit: np.ndarray, noise: Optional[np.ndarray] = None) -> str:
    """Observed vs fitted spectra per ray + normalised residuals.

    y_obs/y_fit: [n_ray, n_chan]; ``noise`` masks windowed-out channels
    (non-finite or huge noise => excluded from the residual panel).
    """
    plt = _plt()
    fig, (ax, axr) = plt.subplots(
        2, 1, figsize=(9, 6), sharex=True,
        gridspec_kw={"height_ratios": [3, 1]})
    R = y_obs.shape[0]
    for r in range(R):
        ax.plot(chans, y_obs[r], ".", ms=2.5, color=f"C{r % 10}", alpha=0.6)
        ax.plot(chans, y_fit[r], lw=0.9, color=f"C{r % 10}",
                label=f"ray {r}" if R <= 12 else None)
    ax.set_ylabel("radiance [W m$^{-2}$ sr$^{-1}$ (cm$^{-1}$)$^{-1}$]")
    ax.set_title("observed (dots) vs fitted (lines)")
    if R <= 12:
        ax.legend(fontsize=7)
    for r in range(R):
        resid = y_obs[r] - y_fit[r]
        if noise is not None:
            n_r = noise[r]
            ok = np.isfinite(n_r) & (n_r < 1e30)
            resid = np.where(ok, resid / np.where(ok, n_r, 1.0), np.nan)
        axr.plot(chans, resid, lw=0.7, color=f"C{r % 10}")
    axr.axhline(0.0, color="k", lw=0.5)
    axr.set_xlabel("wavenumber [cm$^{-1}$]")
    axr.set_ylabel(r"resid / $\sigma$" if noise is not None else "resid")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path
