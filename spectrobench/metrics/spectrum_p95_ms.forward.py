"""spectrum_p95_ms.forward [ms]: the 95th percentile of the per-spectrum
time (state to the card, forward, radiances on the host) over the
window's spectra (host clock)."""

import numpy as np


def read(rec):
    t = [u["wall_s"] for u in rec["units"] if "issue_s" in u]
    return 1e3 * float(np.percentile(t, 95)) if t else None
