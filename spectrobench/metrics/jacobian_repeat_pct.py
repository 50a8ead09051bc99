"""jacobian_repeat_pct [%]: the share of the LM loop's Jacobians taken at
the state of the one before (after a rejected step; a posterior at an
unchanged state): 100 x ``jacobians_repeated`` / ``jacobians`` of the
program's counts (``spectrobot_tpu_torch.retrieval.oe.COUNTS``) over the
run's whole process."""


def read(rec):
    if not rec.get("units"):
        return None
    from spectrobot_tpu_torch.retrieval import oe
    counts = getattr(oe, "COUNTS", None)
    if not counts or not counts["jacobians"]:
        return None
    return 100.0 * counts["jacobians_repeated"] / counts["jacobians"]
