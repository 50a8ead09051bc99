"""``python -m spectrobench``: one run of one cell (:mod:`spectrobench.run`).
The process's start time is taken before anything is imported: the
set-up time counts the imports too."""

import time

_T0 = time.time()

if __name__ == "__main__":
    import os

    # The program's libraries may not bring JAX in on their own.
    os.environ.setdefault("USE_FLAX", "0")
    from spectrobench.run import main

    raise SystemExit(main(t0=_T0))
