"""retrieval_p90_s [s]: the 90th percentile of the per-scan time (problem,
Jacobian, LM loop and fitted forward, until the fit is on the host) over
every scan of the window, converged or not (host clock; linear
interpolation between order statistics)."""

import numpy as np


def read(rec):
    walls = [u["wall_s"] for u in rec["units"] if "converged" in u]
    if not walls:
        return None
    return float(np.percentile(walls, 90))
