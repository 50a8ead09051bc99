"""jac_prologue_ms [ms]: the device time of the forward's path and prologue
a Jacobian (the Curtis-Godson paths, the line parameters of every state):
per ``spectrobot.jacobian`` span of the traced segment, the ``device_ms`` of
the ``spectrobot.forward.path`` and ``spectrobot.forward.prologue`` spans
it holds, summed; the mean over the Jacobians (``jac_line_sum_ms.py``).

It is mostly host issue under the profiler, not device work: the phase is
many small launches, which the host issues more slowly than the device
runs them (on an H100, 14 ms of kernels in a 43-59 ms phase), and the
profiler slows the host by about a fifth.  The unit run under the profiler
before the traced window, which takes the profiler's start-up, is in the
mean too.  Judge a change to this phase by ``retrievals_per_s`` and
``device_idle_pct.retrieve``, not by this number alone."""

from spectrobench import manifest

PHASES = ("spectrobot.forward.path", "spectrobot.forward.prologue")


def read(rec):
    return manifest._module("metrics", "jac_line_sum_ms").per_jacobian_ms(
        rec, PHASES)
