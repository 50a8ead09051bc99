"""jac_epilogue_ms [ms]: the device time of the forward's epilogue and ILS
a Jacobian (sources, the path RT, the FOV, the channels): per
``spectrobot.jacobian`` span of the traced segment, the ``device_ms`` of the
``spectrobot.forward.epilogue`` and ``spectrobot.forward.ils`` spans it
holds, summed; the mean over the Jacobians (``jac_line_sum_ms.py``)."""

from spectrobench import manifest

PHASES = ("spectrobot.forward.epilogue", "spectrobot.forward.ils")


def read(rec):
    return manifest._module("metrics", "jac_line_sum_ms").per_jacobian_ms(
        rec, PHASES)
