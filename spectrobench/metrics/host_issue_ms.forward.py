"""host_issue_ms.forward [ms]: host time from a spectrum's call into the
forward to its return, before the copy to the host waits for the device
(the mean over the window's spectra)."""


def read(rec):
    t = [u["issue_s"] for u in rec["units"] if "issue_s" in u]
    return 1e3 * sum(t) / len(t) if t else None
