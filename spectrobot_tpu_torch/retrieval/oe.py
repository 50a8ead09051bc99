"""Optimal-estimation / Levenberg-Marquardt inversion (port of
``spectrobot_tpu.retrieval.oe``).

The device callables (forward and Jacobian) take and return torch tensors in
the compute dtype; the LM algebra (normal equations, solve, chi^2 and the
lambda bookkeeping) runs on the host in float64 numpy, as in the reference:
the normal equations carry condition numbers of 1e6 and more, which a
float32 solve turns into garbage steps.  Every iteration is logged and every
accepted one checkpointed, so a restart re-enters at the last accepted
iteration.

Each iteration runs in the span ``spectrobot.lm.iteration``
(``utils.profiling.annotate``, recorded only while a profiler runs), its
host algebra in ``spectrobot.lm.normal_equations``, ``.solve`` and
``.cost``, the algebra after the loop in ``spectrobot.lm.posterior``; the
copies of device results to the host stay outside them.  :data:`COUNTS`
counts the Jacobians and those repeated at an unchanged state, always.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from spectrobot_tpu_torch.utils.profiling import annotate

# The LM loop's counts over every :func:`retrieve` of the process: the
# Jacobians (every call of ``jacobian`` or ``normal_eqs``, the posterior's
# included) and those at a state bit-equal to the previous call's within
# one retrieval (after a rejected step; a posterior at an unchanged state).
# The benchmark's ``jacobian_repeat_pct`` reads them.
COUNTS = {"jacobians": 0, "jacobians_repeated": 0}


@dataclasses.dataclass
class OEConfig:
    max_iter: int = 20
    lm_lambda0: float = 1.0e-2
    lm_up: float = 10.0          # lambda multiplier on rejected step
    lm_down: float = 0.3         # lambda multiplier on accepted step
    chi2_rel_tol: float = 1e-3   # convergence: relative chi2 change
    dx2_tol: float = 0.1         # convergence: d-squared < tol * n_x (Rodgers)
    lambda_max: float = 1e8


@dataclasses.dataclass
class RetrievalResult:
    x: np.ndarray                # retrieved flat state
    chi2: float                  # final total cost (measurement + prior)
    chi2_meas: float
    n_iter: int
    converged: bool
    S_hat: np.ndarray            # posterior covariance
    A_kernel: np.ndarray         # averaging-kernel matrix
    dof: float                   # degrees of freedom for signal, tr(A)
    history: List[Dict]          # per-iteration records
    K: np.ndarray                # final Jacobian
    # Why the loop stopped: "d2_tol" / "chi2_tol" (converged), "max_iter"
    # (budget spent; history[-1]["accepted"] says whether chi2 was still
    # improving), "lambda_max" (no damping gave an acceptable step).
    stop_reason: str = ""


def _host(a) -> np.ndarray:
    """A device result as a float64 host array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _chi2_terms(y, F, x, x_a, inv_se_diag, S_a_inv):
    """Host-side (float64 numpy) chi^2 bookkeeping."""
    r = _host(y) - _host(F)
    meas = float(np.dot(r * _host(inv_se_diag), r))
    dxa = _host(x) - _host(x_a)
    prior = float(dxa @ (_host(S_a_inv) @ dxa))
    return meas, prior


def _lm_solve(x, H, g, x_a, S_a_inv, lam):
    """LM solve from the normal equations H = K^T Se^-1 K and
    g = K^T Se^-1 (y - F), in float64 numpy on the host:

        (H + S_a^-1 + lam*diag(S_a^-1)) dx = g - S_a^-1 (x - x_a)
    """
    x64 = _host(x)
    Sai = _host(S_a_inv)
    A = _host(H) + Sai + lam * np.diag(np.diag(Sai))
    b = _host(g) - Sai @ (x64 - _host(x_a))
    dx = np.linalg.solve(A, b)
    d2 = float(dx @ b)     # Rodgers convergence metric
    return x64 + dx, dx, d2


def _normal_equations(K, F, y, inv_se_diag):
    """H = K^T Se^-1 K and g = K^T Se^-1 (y - F) on the host in float64
    (host arrays)."""
    KtSe = K.T * inv_se_diag[None, :]
    return KtSe @ K, KtSe @ (y - F)


def _lm_step(x, K, F, y, x_a, inv_se_diag, S_a_inv, lam):
    """One LM step from the Jacobian: the normal equations assembled on
    the host in float64 (span ``spectrobot.lm.normal_equations``), then
    :func:`_lm_solve` (span ``spectrobot.lm.solve``).  :func:`retrieve`
    passes K already copied to the host, so that the spans time the
    algebra and not the wait for the device."""
    with annotate("spectrobot.lm.normal_equations"):
        H, g = _normal_equations(_host(K), _host(F), _host(y),
                                 _host(inv_se_diag))
    with annotate("spectrobot.lm.solve"):
        return _lm_solve(x, H, g, x_a, S_a_inv, lam)


def retrieve(
    forward_flat: Callable[[torch.Tensor], torch.Tensor],
    jacobian: Callable[[torch.Tensor], torch.Tensor],
    y,
    x0: torch.Tensor,
    x_a,
    S_a: np.ndarray,
    noise_sigma,
    cfg: OEConfig = OEConfig(),
    logger=None,
    checkpointer=None,
    normal_eqs=None,
    state_check=None,
) -> RetrievalResult:
    """Run the OE/LM loop to convergence.

    forward_flat / jacobian: flat-state callables (``retrieval.state``);
    they receive ``x0``'s dtype and device.  noise_sigma: per-channel
    measurement noise (diagonal S_eps).  logger: optional
    ``spectrobot_tpu_torch.utils.runlog.RunLogger``; checkpointer: optional
    ``spectrobot_tpu_torch.utils.checkpoint.Checkpointer`` (resumes from its
    ``latest()``).  normal_eqs: optional x -> (F, H, g), H = K^T Se^-1 K
    and g = K^T Se^-1 (y - F) assembled where the Jacobian lives (the
    mesh's ``parallel.oe.ShardedOE``): each LM iteration then moves only
    O(n_x^2) numbers to the host, and ``jacobian`` runs once, for the
    posterior diagnostics.  state_check: optional x -> str | None, called on every
    accepted state; a message is warned and logged, and the loop goes on.
    """
    inv_se = 1.0 / _host(noise_sigma) ** 2
    S_a = _host(S_a)
    S_a_inv = np.linalg.inv(S_a)
    x = _host(x0)
    x_a = _host(x_a)
    dev = lambda v: torch.as_tensor(v, dtype=x0.dtype, device=x0.device)
    lam = cfg.lm_lambda0
    history: List[Dict] = []
    start_iter = 0

    if checkpointer is not None:
        ck = checkpointer.latest()
        if ck is not None:
            x_ck = _host(ck["x"])
            if x_ck.shape != tuple(x0.shape):
                raise ValueError(
                    f"checkpoint in {checkpointer.dir!r} carries "
                    f"{x_ck.shape[0]} state parameters but this retrieval "
                    f"has {x0.shape[0]}: the retrieval configuration "
                    f"changed since it was written; delete the checkpoint "
                    f"directory or point run.checkpoint_dir elsewhere to "
                    f"start fresh")
            x = x_ck
            lam = float(ck["lam"])
            start_iter = int(ck["iteration"]) + 1
            history = list(ck.get("history", []))

    F = _host(forward_flat(dev(x)))
    y = _host(y)
    chi2_m, chi2_p = _chi2_terms(y, F, x, x_a, inv_se, S_a_inv)
    chi2 = float(chi2_m + chi2_p)
    converged = False
    stop_reason = "max_iter"
    n_x = x.shape[0]
    it = start_iter
    jac_at = None       # the state of the last Jacobian

    def count_jacobian(x):
        nonlocal jac_at
        COUNTS["jacobians"] += 1
        if jac_at is not None and np.array_equal(jac_at, x):
            COUNTS["jacobians_repeated"] += 1
        jac_at = x.copy()

    for it in range(start_iter, cfg.max_iter):
        with annotate("spectrobot.lm.iteration"):
            t0 = time.time()
            count_jacobian(x)
            if normal_eqs is not None:
                _, H, g = normal_eqs(dev(x))
                H, g = _host(H), _host(g)
                with annotate("spectrobot.lm.solve"):
                    x_try, dx, d2 = _lm_solve(x, H, g, x_a, S_a_inv, lam)
            else:
                K = _host(jacobian(dev(x)))
                x_try, dx, d2 = _lm_step(x, K, F, y, x_a, inv_se, S_a_inv,
                                         lam)
            F_try = _host(forward_flat(dev(x_try)))
            with annotate("spectrobot.lm.cost"):
                m_try, p_try = _chi2_terms(y, F_try, x_try, x_a, inv_se,
                                           S_a_inv)
            chi2_try = float(m_try + p_try)
            accepted = chi2_try < chi2

            rec = {
                "iteration": it, "lambda": float(lam), "chi2": chi2,
                "chi2_try": chi2_try, "accepted": bool(accepted),
                "d2": float(d2), "norm_dx": float(np.linalg.norm(dx)),
                "wall_s": time.time() - t0,
            }
            history.append(rec)
            if logger is not None:
                logger.log(rec)

            # Rodgers d^2 criterion: the predicted improvement is negligible,
            # converged whether or not the step was accepted.
            if float(d2) < cfg.dx2_tol * n_x:
                if accepted:
                    x, F, chi2 = x_try, F_try, chi2_try
                converged = True
                stop_reason = "d2_tol"
                break

            if accepted:
                rel = (chi2 - chi2_try) / max(chi2, 1e-300)
                x, F, chi2 = x_try, F_try, chi2_try
                if state_check is not None:
                    msg = state_check(x)
                    if msg:
                        import warnings
                        warnings.warn(msg, stacklevel=2)
                        if logger is not None:
                            logger.log({"iteration": it,
                                        "physics_warning": msg})
                lam = max(lam * cfg.lm_down, 1e-12)
                if checkpointer is not None:
                    checkpointer.save(it, x=np.asarray(x), lam=lam,
                                      history=history)
                if rel < cfg.chi2_rel_tol:
                    converged = True
                    stop_reason = "chi2_tol"
                    break
            else:
                lam *= cfg.lm_up
                if lam > cfg.lambda_max:
                    stop_reason = "lambda_max"
                    break

    # Posterior covariance and averaging kernels (Rodgers 2000), at the
    # retrieved state.
    count_jacobian(x)
    K = _host(jacobian(dev(x)))
    with annotate("spectrobot.lm.posterior"):
        KtSe = K.T * inv_se[None, :]
        H = KtSe @ K
        S_hat = np.linalg.inv(H + S_a_inv)
        A_kernel = S_hat @ H
        chi2_m, _ = _chi2_terms(y, F, x, x_a, inv_se, S_a_inv)

    return RetrievalResult(
        x=x, chi2=chi2, chi2_meas=float(chi2_m), n_iter=it + 1,
        converged=converged, S_hat=S_hat, A_kernel=A_kernel,
        dof=float(np.trace(A_kernel)), history=history, K=K,
        stop_reason=stop_reason)
