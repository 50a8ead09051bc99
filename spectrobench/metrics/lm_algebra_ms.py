"""lm_algebra_ms [ms]: the LM loop's host algebra an iteration: the
``host_ms`` of every ``spectrobot.lm.normal_equations``, ``.solve``,
``.cost`` and ``.posterior`` span of the traced segment (float64 numpy; the
copies of device results stay outside them), over the number of
``spectrobot.lm.iteration`` spans (``jac_line_sum_ms.py``)."""

from spectrobench import manifest

ALGEBRA = ("spectrobot.lm.normal_equations", "spectrobot.lm.solve",
           "spectrobot.lm.cost", "spectrobot.lm.posterior")


def read(rec):
    recs = manifest._module("metrics", "jac_line_sum_ms").program_spans(rec)
    its = sum(r["name"] == "spectrobot.lm.iteration" for r in recs or ())
    if not its:
        return None
    return sum(r["host_ms"] for r in recs if r["name"] in ALGEBRA) / its
