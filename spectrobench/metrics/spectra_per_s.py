"""spectra_per_s [spectra/s]: spectra delivered to the host over the whole
window (host clock)."""


def read(rec):
    units = [u for u in rec["units"] if "issue_s" in u]
    if not units:
        return None
    return len(units) / rec["window_s"]
