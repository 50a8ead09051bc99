"""jac_fov_ms [ms]: the device time of the field of view's smear a
Jacobian (V @ I over the fine ladder of rays, inside the epilogue): per
``spectrobot.jacobian`` span of the traced segment, the ``device_ms`` of
the ``spectrobot.forward.fov`` spans it holds, summed; the mean over the
Jacobians (``jac_line_sum_ms.py``).  None where the program has no such
span (a scene without a field of view, or a program before the span)."""

from spectrobench import manifest

PHASES = ("spectrobot.forward.fov",)


def read(rec):
    return manifest._module("metrics", "jac_line_sum_ms").per_jacobian_ms(
        rec, PHASES)
