"""retrievals_per_s [retrievals/s]: converged retrievals completed over the
whole window (host clock); a scan that fails or does not converge adds
nothing."""


def read(rec):
    units = [u for u in rec["units"] if "converged" in u]
    if not units:
        return None
    return sum(u["converged"] for u in units) / rec["window_s"]
