"""Distributed Jacobian assembly for the LM solve (port of
``spectrobot_tpu.parallel.retrieval``).

The measurement vector y, and so every Jacobian ROW, is sharded over the
mesh axes its layout still carries (``row_axes``: ``ray``, and ``nu`` when
no instrument function mixes the fine grid).  The LM normal equations need
the global

    H = K^T Se^-1 K   [n_x, n_x],     g = K^T Se^-1 r   [n_x]

* :func:`sharded_normal_equations`: each rank contracts its local rows and
  one all-reduce per row axis sums them: O(n_x^2) traffic, whatever n_y.
* :func:`allgather_jacobian`: the full K on every rank, row order included,
  for the posterior diagnostics.

A rank's rows are its [R_loc, C_loc] tile of the [R, C] measurement grid
(rays by channels or grid points), flattened; the ranks along an axis that
is not a row axis hold the same rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from spectrobot_tpu_torch.parallel.collectives import all_gather, psum


def sharded_normal_equations(mesh, K: torch.Tensor, r: torch.Tensor,
                             inv_se: torch.Tensor,
                             axes: Tuple[str, ...] = ("ray", "nu")):
    """(H, g) on every rank, in float64, from this rank's rows: K
    [n_rows, n_x], the residual r and the inverse noise variances inv_se
    [n_rows], summed over the row axes ``axes``.  The products run in
    float64 on the rank's device (no TF32), whatever K's dtype: the normal
    equations carry condition numbers of 1e6 and more."""
    K = K.to(torch.float64)
    KtSe = K.T * inv_se.to(torch.float64)[None, :]
    H = psum(KtSe @ K, mesh, axes)
    g = psum(KtSe @ r.to(torch.float64), mesh, axes)
    return H, g


def allgather_jacobian(mesh, K: torch.Tensor, tile: Tuple[int, int],
                       axes: Tuple[str, ...] = ("ray", "nu")
                       ) -> torch.Tensor:
    """The full K [n_y, ...] on every rank from this rank's rows K
    [R_loc * C_loc, ...] (``tile`` = (R_loc, C_loc)): gathered over ``nu``
    along the columns of the tile, then over ``ray`` along its rows, so the
    rows come back in the global (ray-major, channel-minor) order."""
    R_loc, C_loc = tile
    K = K.reshape(R_loc, C_loc, *K.shape[1:])
    if "nu" in axes:
        K = all_gather(K, mesh, "nu", 1)
    if "ray" in axes:
        K = all_gather(K, mesh, "ray", 0)
    return K.reshape(-1, *K.shape[2:])
