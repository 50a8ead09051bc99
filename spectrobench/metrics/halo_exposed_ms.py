"""halo_exposed_ms [ms]: the nu-halo exchange's exposed time a forward:
per traced forward and card, the time the exchange's kernels (the ring
kernel of a graph replay, NCCL's send/receive eagerly) ran with no other
kernel running, the largest over the cards, the mean over the forwards."""

from spectrobench.yardstick.trace import exposed_us

EXCHANGE = "dma_ring_kernel"


def _kind(name):
    low = name.lower()
    if EXCHANGE in low:
        return "exchange"
    if "nccl" not in low:
        return "compute"
    return "exchange" if ("send" in low or "recv" in low) else "collective"


def read(rec):
    traces = rec.get("trace")
    if not traces or len(traces) < 2:
        return None
    n = min(len(t["units"]) for t in traces)
    per_unit = []
    for j in range(n):
        worst, seen = 0.0, False
        for t in traces:
            u0, u1 = t["units"][j]
            ev = [(s, e, _kind(nm)) for nm, s, e, _ in t["events"]
                  if s < u1 and e > u0]
            ex = [(max(s, u0), min(e, u1)) for s, e, k in ev
                  if k == "exchange"]
            comp = [(max(s, u0), min(e, u1)) for s, e, k in ev
                    if k == "compute"]
            if ex:
                seen = True
                worst = max(worst, exposed_us(ex, comp))
        if seen:
            per_unit.append(worst)
    return sum(per_unit) / len(per_unit) / 1e3 if per_unit else None
