"""ctypes bridge to the native C++ HITRAN parser (native/hitran_parser.cpp).

Build once with ``make -C native`` (g++, no external deps).  Falls back
cleanly: :func:`available` is False when the shared library is absent and
callers keep using the NumPy parser in :mod:`spectrobot_tpu_torch.data.hitran`.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native",
    "libspectrobot_native.so")

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    D = ctypes.POINTER(ctypes.c_double)
    I = ctypes.POINTER(ctypes.c_int32)
    lib.spectrobot_parse_par.restype = ctypes.c_long
    lib.spectrobot_parse_par.argtypes = (
        [ctypes.c_char_p, ctypes.c_long] + [D] * 10
        + [I, I, ctypes.c_char_p, ctypes.c_long])
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def parse_par_bytes(data: bytes):
    """Parse raw .par bytes -> dict of columns (same contract as the NumPy
    parser's internals).  Raises RuntimeError if the library is missing."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"native parser not built; run `make -C native` ({_LIB_PATH})")
    # Upper bound on record count: one per newline (+1 tail line).
    max_rec = data.count(b"\n") + 1
    cols = {name: np.zeros(max_rec, dtype=np.float64) for name in (
        "nu0", "sw", "a_einstein", "gamma_air", "gamma_self", "elower",
        "n_air", "delta_air", "gp", "gpp")}
    mol = np.zeros(max_rec, dtype=np.int32)
    iso = np.zeros(max_rec, dtype=np.int32)
    quanta = np.zeros(max_rec * 60, dtype=np.uint8)

    D = ctypes.POINTER(ctypes.c_double)
    I = ctypes.POINTER(ctypes.c_int32)
    ptr = lambda arr: arr.ctypes.data_as(D)
    n = lib.spectrobot_parse_par(
        data, len(data),
        ptr(cols["nu0"]), ptr(cols["sw"]), ptr(cols["a_einstein"]),
        ptr(cols["gamma_air"]), ptr(cols["gamma_self"]), ptr(cols["elower"]),
        ptr(cols["n_air"]), ptr(cols["delta_air"]), ptr(cols["gp"]),
        ptr(cols["gpp"]),
        mol.ctypes.data_as(I), iso.ctypes.data_as(I),
        quanta.ctypes.data_as(ctypes.c_char_p), max_rec)
    if n < 0:
        raise RuntimeError("native parser returned error")
    n = int(n)
    out = {k: v[:n] for k, v in cols.items()}
    out["mol_id"] = mol[:n]
    out["iso_id"] = iso[:n]
    q = np.frombuffer(quanta[: n * 60].tobytes(), dtype="S15").reshape(n, 4)
    q = np.char.decode(q, "latin-1")
    out["quanta_global_u"] = q[:, 0]
    out["quanta_global_l"] = q[:, 1]
    out["quanta_local_u"] = q[:, 2]
    out["quanta_local_l"] = q[:, 3]
    return out
