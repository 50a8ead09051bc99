"""The (P, T) table runtime over the (ray, line, nu) mesh (port of
``spectrobot_tpu.parallel.sharded_lut``).

A table has no line axis (its entries are line sums already), so it cuts
along two mesh axes:

* ``nu``  -- every table's wavenumber (last) axis and the grid: the
  bilinear (T, log p) interpolation is pointwise in nu, so each rank
  interpolates its own chunk of the tables.  No halo, no all-reduce.
* ``ray`` -- Curtis-Godson states, pure data parallelism.

The ``line`` axis is redundant: every line rank computes the same values,
so the results are replicated across it, and the LUT tier runs on the same
mesh objects as the line-by-line paths.  The interpolation carries the
tangents of (T, log p), so ``parallel.oe``'s Jacobian runs through this
forward unchanged: table lookups per LM iteration instead of line sums.
The field of view and the instrument function mix the sharded axes and
stay with the caller (``parallel.oe``).
"""

from __future__ import annotations

from spectrobot_tpu_torch.forward.limb import tau_radiance_epilogue
from spectrobot_tpu_torch.ops.lut import NLTELUT, table_depths


def stage_lut_sharded(mesh, lut):
    """This rank's block of ``lut`` (an ``ops.lut.OpacityLUT`` or
    ``NLTELUT``): every table and the grid cut by the rank's ``nu`` block
    of the wavenumber axis (contiguous, so a lookup gathers without a
    copy); the lattice, the group maps and the VMRs whole."""
    nb = mesh.block(lut.nu_grid.shape[0], "nu")
    cut = lambda t: t[..., nb].contiguous()
    if isinstance(lut, NLTELUT):
        return lut._replace(nu_grid=cut(lut.nu_grid),
                            sigma_l=cut(lut.sigma_l),
                            sigma_u=cut(lut.sigma_u),
                            sigma_e=cut(lut.sigma_e))
    return lut._replace(nu_grid=cut(lut.nu_grid), sigma=cut(lut.sigma))


def sharded_lut_radiance_fn(*, is_limb: bool = True,
                            emissivity: float = 1.0):
    """The table radiance function of a rank:
    f(lut_loc, cg_loc, nlte=None, I_bg=None, cia=None) -> I_loc [R_loc,
    P_loc], with ``lut_loc`` from :func:`stage_lut_sharded` (an
    ``NLTELUT`` takes the populations ``nlte``), ``cg_loc`` the rank's
    rays, ``I_bg`` and ``cia`` its ``nu`` blocks (as
    ``parallel.sharded.stage_sharded`` cuts them).  Nadir
    (``is_limb=False``) over a grey surface as ``sharded_radiance_fn``."""
    def apply(lut_loc, cg_loc, nlte=None, I_bg=None, cia=None):
        dtau, dtau_em = table_depths(lut_loc, cg_loc, nlte)
        return tau_radiance_epilogue(lut_loc.nu_grid.to(dtau.dtype), cg_loc,
                                     dtau, dtau_em, cia=cia,
                                     I_background=I_bg, is_limb=is_limb,
                                     emissivity=emissivity)

    return apply
