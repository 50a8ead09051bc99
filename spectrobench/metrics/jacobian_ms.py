"""jacobian_ms [ms]: the synchronised wall time of a Jacobian call (the
call until the device has finished), the mean over the window's calls."""


def read(rec):
    calls = [t for u in rec["units"] for t in u.get("jacobian_s", ())]
    return 1e3 * sum(calls) / len(calls) if calls else None
