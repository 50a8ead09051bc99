"""Structured run logging (SURVEY.md section 6: metrics/observability).

The reference prints and plots; here every LM iteration / benchmark sample is
one JSON line (machine-readable) plus an optional compact console echo.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional, TextIO


class RunLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self._fh: Optional[TextIO] = open(path, "a") if path else None
        self.echo = echo
        self.t0 = time.time()

    def log(self, record: dict) -> None:
        rec = {"t": round(time.time() - self.t0, 3), **record}
        line = json.dumps(rec, default=float)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            keys = ("iteration", "chi2", "lambda", "accepted")
            brief = " ".join(f"{k}={rec[k]:.4g}" if isinstance(rec.get(k), float)
                             else f"{k}={rec.get(k)}" for k in keys if k in rec)
            print(f"[runlog {rec['t']:8.1f}s] {brief}", file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
