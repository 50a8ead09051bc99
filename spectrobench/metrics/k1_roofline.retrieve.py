"""k1_roofline.retrieve [%]: K1's share of its roofline over a retrieval's
traced segment: the bound of the primal line sums its forwards and
Jacobians required (the yardstick's region counts at each call's state,
primal flops or bytes: ``yardstick/roofline.py``) over K1's device time
(the profiler's events of the kernel names below)."""

from spectrobench.yardstick.trace import kernel_share

KERNELS = ("opacity_batch_kernel",)


def read(rec):
    return kernel_share(rec, KERNELS, "k1_ms")
