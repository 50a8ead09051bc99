"""lm_iters_per_retrieval: the LM loop's iterations per scan over the
window (``RetrievalResult.n_iter``, the program's count)."""


def read(rec):
    its = [u["n_iter"] for u in rec["units"] if "n_iter" in u]
    return sum(its) / len(its) if its else None
