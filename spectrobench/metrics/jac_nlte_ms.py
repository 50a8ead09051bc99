"""jac_nlte_ms [ms]: the device time of the non-LTE layer weights a
Jacobian (each line's absorption and emission weights at every (ray,
layer) state, inside the prologue): per ``spectrobot.jacobian`` span of the
traced segment, the ``device_ms`` of the ``spectrobot.forward.nlte`` spans
it holds, summed; the mean over the Jacobians (``jac_line_sum_ms.py``).
None where the program has no such span (an LTE scene, or a program
before the span)."""

from spectrobench import manifest

PHASES = ("spectrobot.forward.nlte",)


def read(rec):
    return manifest._module("metrics", "jac_line_sum_ms").per_jacobian_ms(
        rec, PHASES)
