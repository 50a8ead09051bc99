"""mfu_pct.retrieve [%]: the whole scan's share of the card's peak: the
roofline-bound time of all the line-sum work the traced segment required
(K1's primal sums at every forward and Jacobian, K2's tangents at every
Jacobian; ``yardstick/roofline.py``) over the segment's length times the
cards, whatever kernels did the work."""

from spectrobench.yardstick.trace import bound_share


def read(rec):
    return bound_share(rec)
