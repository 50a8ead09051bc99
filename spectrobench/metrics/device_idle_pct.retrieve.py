"""device_idle_pct.retrieve [%]: the share of the traced segment in which
no operation ran on the device (1 - the union of the profiler's device
intervals over the window), the mean over the cards."""

from spectrobench.yardstick.trace import idle_pct


def read(rec):
    return idle_pct(rec)
