"""k2_roofline [%]: K2's share of its roofline over the traced segment:
the bound of the tangent line sums the segment's Jacobians required
(the yardstick's region counts at each call's state, K2's basis flops,
3xTF32 contraction at 2 n_x rows and bytes: ``yardstick/roofline.py``)
over K2's device time, summed over the cards (the profiler's events of the
kernel names below)."""

from spectrobench.yardstick.trace import kernel_share

KERNELS = ("basis_batch_kernel",)


def read(rec):
    return kernel_share(rec, KERNELS, "k2_ms")
