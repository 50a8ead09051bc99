"""Retrieval checkpoint/resume (SURVEY.md section 6).

The reference (fedef17/SpectRobot) pickles intermediate objects; restart
means rerunning the script.  Here every accepted LM iteration lands in an
atomic ``.npz`` (write-temp + rename), and ``latest()`` re-enters at the last
completed iteration — the failure-recovery contract of SURVEY.md section 6
("retrieval-loop state checkpointed each LM iteration; restart re-enters at
last iteration").
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

import numpy as np


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, iteration: int) -> str:
        return os.path.join(self.dir, f"lm_iter_{iteration:05d}.npz")

    def save(self, iteration: int, *, x: np.ndarray, lam: float,
             history=None, **extra) -> str:
        payload = {"x": np.asarray(x), "lam": np.float64(lam),
                   "iteration": np.int64(iteration)}
        if history is not None:
            payload["history_json"] = np.frombuffer(
                json.dumps(history).encode(), dtype=np.uint8)
        payload.update({k: np.asarray(v) for k, v in extra.items()})
        path = self._path(iteration)
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, path)                      # atomic on POSIX
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._gc()
        return path

    def _gc(self) -> None:
        files = sorted(f for f in os.listdir(self.dir)
                       if f.startswith("lm_iter_") and f.endswith(".npz"))
        for f in files[:-self.keep]:
            os.unlink(os.path.join(self.dir, f))

    def latest(self) -> Optional[Dict]:
        files = sorted(f for f in os.listdir(self.dir)
                       if f.startswith("lm_iter_") and f.endswith(".npz"))
        if not files:
            return None
        with np.load(os.path.join(self.dir, files[-1])) as z:
            out = {k: z[k] for k in z.files}
        if "history_json" in out:
            out["history"] = json.loads(bytes(out.pop("history_json")).decode())
        return out
