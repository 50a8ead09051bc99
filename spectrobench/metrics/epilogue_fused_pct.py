"""epilogue_fused_pct [%]: the share of the forward's RT epilogue calls
that took the fused kernel: 100 x ``fused`` / (``fused`` + ``composed``) of
the program's epilogue counts (``spectrobot_tpu_torch.forward.limb.
EPILOGUE_COUNTS``: host-issued calls, eager ones and graph captures; a
graph's replays issue none), over the run's whole process.  None where the
program keeps no such counts or made no call."""


def read(rec):
    if not rec.get("units"):
        return None
    from spectrobot_tpu_torch.forward import limb
    counts = getattr(limb, "EPILOGUE_COUNTS", None)
    if not counts:
        return None
    total = counts["fused"] + counts["composed"]
    return 100.0 * counts["fused"] / total if total else None
