"""mfu_pct.forward [%]: the whole spectrum's share of the card's peak: the
roofline-bound time of all the line-sum work the traced segment required
(K1's primal sums of every spectrum over the whole grid;
``yardstick/roofline.py``) over the segment's length times the cards,
whatever kernels did the work."""

from spectrobench.yardstick.trace import bound_share


def read(rec):
    return bound_share(rec)
