"""jac_line_sum_ms [ms]: the device time of the line sum a Jacobian (K1,
and under jacfwd the basis coefficients and K2): per ``spectrobot.jacobian``
span of the traced segment, the ``device_ms`` of the
``spectrobot.forward.line_sum`` spans it holds, summed; the mean over the
Jacobians.  The spans are the program's own records
(``spectrobot_tpu_torch.utils.profiling.spans``), kept while the profiler
ran: the unit before the traced window and the window's units."""

JACOBIAN = "spectrobot.jacobian"
PHASES = ("spectrobot.forward.line_sum",)


def program_spans(rec):
    """The program's span records, or None without a traced segment,
    where the program keeps none, or where its bounded list let records
    go (``dropped_spans``): a mean over a cut list would change without
    a sign."""
    if not rec.get("trace"):
        return None
    from spectrobot_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    if spans is None or profiling.dropped_spans():
        return None
    return spans()


def per_jacobian_ms(rec, phases):
    """The device time [ms] of the spans named ``phases`` inside each
    Jacobian's span, summed a Jacobian, the mean over the Jacobians that
    hold one with a device time; None where none does."""
    recs = program_spans(rec)
    if not recs:
        return None
    by_id = {r["id"]: r for r in recs}
    total = {}
    for r in recs:
        if r["name"] not in phases or r["device_ms"] is None:
            continue
        p = r["parent"]
        while p in by_id and by_id[p]["name"] != JACOBIAN:
            p = by_id[p]["parent"]
        if p in by_id:
            total[p] = total.get(p, 0.0) + r["device_ms"]
    return sum(total.values()) / len(total) if total else None


def read(rec):
    return per_jacobian_ms(rec, PHASES)
