"""lm_host_ms [ms]: host time an LM iteration outside the forward and
Jacobian calls: each scan's time less the synchronised time of its
forward and Jacobian calls, over its iterations, summed over the window's
scans (the benchmark's spans around the calls into the program)."""


def read(rec):
    units = [u for u in rec["units"] if "n_iter" in u]
    its = sum(u["n_iter"] for u in units)
    if not its:
        return None
    outside = sum(u["wall_s"] - sum(u["forward_s"]) - sum(u["jacobian_s"])
                  for u in units)
    return 1e3 * outside / its
