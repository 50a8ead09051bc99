"""k1_roofline.forward [%]: K1's share of its roofline over a forward
cell's traced segment: the bound of the primal line sums its spectra
required over the whole grid (the yardstick's region counts at each
spectrum's state, primal flops or bytes: ``yardstick/roofline.py``) over
K1's device time summed over the cards (the profiler's events of the
kernel names below)."""

from spectrobench.yardstick.trace import kernel_share

KERNELS = ("opacity_batch_kernel",)


def read(rec):
    return kernel_share(rec, KERNELS, "k1_ms")
