"""HITRAN line-list ingestion (component C1 of SURVEY.md section 3).

The reference (fedef17/SpectRobot, ``spect_classes.py`` [SURVEY.md 1.2]) parses
160-character ``.par`` records into per-line Python objects.  The TPU-native
design is different: lines are parsed host-side ONCE into a columnar
struct-of-arrays (:class:`LineList`), sorted by line-center wavenumber, and
cached as ``.npz``.  Device code only ever sees flat float arrays — no Python
objects, no strings cross into jit.

HITRAN 2004+ .par record layout (fixed width, 160 chars):

    field        cols (1-based)  fmt     meaning
    molec_id     1-2             I2      HITRAN molecule number
    local_iso_id 3               I1      isotopologue index
    nu           4-15            F12.6   vacuum wavenumber         [cm-1]
    sw           16-25           E10.3   line intensity at 296 K   [cm-1/(molec cm-2)]
    a            26-35           E10.3   Einstein A                [s-1]
    gamma_air    36-40           F5.4    air-broadened HWHM        [cm-1/atm]
    gamma_self   41-45           F5.4    self-broadened HWHM      [cm-1/atm]
    elower       46-55           F10.4   lower-state energy        [cm-1]
    n_air        56-59           F4.2    T-dependence exponent of gamma_air
    delta_air    60-67           F8.6    air pressure shift        [cm-1/atm]
    global_u     68-82           A15     upper global (vibrational) quanta
    global_l     83-97           A15     lower global (vibrational) quanta
    local_u      98-112          A15     upper local (rotational) quanta
    local_l      113-127         A15     lower local quanta
    ierr/iref    128-145                 error / reference codes (ignored)
    line_mixing  146             A1      (ignored)
    gp           147-153         F7.1    upper statistical weight
    gpp          154-160         F7.1    lower statistical weight
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from spectrobot_tpu_torch.data.molparams import MOLECULES

# Numeric columns carried by a LineList, in storage order.
_NUMERIC_FIELDS = (
    "nu0",          # line-center vacuum wavenumber [cm-1]
    "sw",           # intensity at 296 K [cm-1/(molec cm-2)], abundance-weighted
    "a_einstein",   # Einstein A [s-1]
    "gamma_air",    # air-broadened HWHM at 296K, 1 atm [cm-1/atm]
    "gamma_self",   # self-broadened HWHM [cm-1/atm]
    "elower",       # lower-state energy [cm-1]
    "n_air",        # T exponent of gamma_air
    "delta_air",    # air-induced pressure shift [cm-1/atm]
    "gp",           # upper state degeneracy
    "gpp",          # lower state degeneracy
    "mass_amu",     # isotopologue mass [amu] (denormalised for kernel use)
)
_INT_FIELDS = (
    "mol_id",       # HITRAN molecule number
    "iso_id",       # isotopologue index
    "level_upper",  # non-LTE level registry index (-1 = unmatched / LTE)
    "level_lower",
)


@dataclasses.dataclass
class LineList:
    """Columnar line list, sorted ascending by ``nu0``.

    All numeric columns are float64 numpy arrays of equal length on the host;
    device code casts to the compute dtype when staging.  ``quanta_*`` are
    host-only object arrays used for non-LTE level matching (C7) and never
    reach the device.
    """

    nu0: np.ndarray
    sw: np.ndarray
    a_einstein: np.ndarray
    gamma_air: np.ndarray
    gamma_self: np.ndarray
    elower: np.ndarray
    n_air: np.ndarray
    delta_air: np.ndarray
    gp: np.ndarray
    gpp: np.ndarray
    mass_amu: np.ndarray
    mol_id: np.ndarray
    iso_id: np.ndarray
    level_upper: np.ndarray
    level_lower: np.ndarray
    # host-only string metadata (global/local quanta), optional
    quanta_global_u: Optional[np.ndarray] = None
    quanta_global_l: Optional[np.ndarray] = None
    quanta_local_u: Optional[np.ndarray] = None
    quanta_local_l: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.nu0.shape[0])

    # ---- construction -----------------------------------------------------

    @staticmethod
    def from_columns(cols: Dict[str, np.ndarray]) -> "LineList":
        n = len(cols["nu0"])
        full: Dict[str, np.ndarray] = {}
        for f in _NUMERIC_FIELDS:
            full[f] = np.asarray(cols.get(f, np.zeros(n)), dtype=np.float64)
        for f in _INT_FIELDS:
            default = np.full(n, -1 if f.startswith("level") else 0)
            full[f] = np.asarray(cols.get(f, default), dtype=np.int32)
        ll = LineList(
            **full,
            quanta_global_u=cols.get("quanta_global_u"),
            quanta_global_l=cols.get("quanta_global_l"),
            quanta_local_u=cols.get("quanta_local_u"),
            quanta_local_l=cols.get("quanta_local_l"),
        )
        return ll.sorted_by_nu0()

    def sorted_by_nu0(self) -> "LineList":
        order = np.argsort(self.nu0, kind="stable")
        return self._take(order)

    def _take(self, idx: np.ndarray) -> "LineList":
        kw = {}
        for f in _NUMERIC_FIELDS + _INT_FIELDS:
            kw[f] = getattr(self, f)[idx]
        for f in ("quanta_global_u", "quanta_global_l", "quanta_local_u", "quanta_local_l"):
            v = getattr(self, f)
            kw[f] = None if v is None else v[idx]
        return LineList(**kw)

    # ---- selection --------------------------------------------------------

    def select(
        self,
        nu_min: Optional[float] = None,
        nu_max: Optional[float] = None,
        wing_cm1: float = 0.0,
        mol_ids: Optional[Sequence[int]] = None,
        min_sw: Optional[float] = None,
    ) -> "LineList":
        """Lines inside [nu_min - wing, nu_max + wing], optionally filtered.

        ``wing_cm1`` keeps lines whose centers sit outside the window but
        whose wings reach into it (SURVEY.md call stack 4.1: "select lines in
        [nu_min - dwing, nu_max + dwing]").
        """
        mask = np.ones(len(self), dtype=bool)
        if nu_min is not None:
            mask &= self.nu0 >= (nu_min - wing_cm1)
        if nu_max is not None:
            mask &= self.nu0 <= (nu_max + wing_cm1)
        if mol_ids is not None:
            mask &= np.isin(self.mol_id, np.asarray(list(mol_ids)))
        if min_sw is not None:
            mask &= self.sw >= min_sw
        return self._take(np.nonzero(mask)[0])

    def for_molecule(self, mol_id: int) -> "LineList":
        return self.select(mol_ids=[mol_id])

    # ---- persistence ------------------------------------------------------

    def save_npz(self, path: str) -> None:
        arrays = {f: getattr(self, f) for f in _NUMERIC_FIELDS + _INT_FIELDS}
        for f in ("quanta_global_u", "quanta_global_l", "quanta_local_u", "quanta_local_l"):
            v = getattr(self, f)
            if v is not None:
                arrays[f] = np.asarray(v, dtype="U15")
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load_npz(path: str) -> "LineList":
        with np.load(path, allow_pickle=False) as z:
            cols = {k: z[k] for k in z.files}
        return LineList.from_columns(cols)

    def concat(self, other: "LineList") -> "LineList":
        cols: Dict[str, np.ndarray] = {}
        for f in _NUMERIC_FIELDS + _INT_FIELDS:
            cols[f] = np.concatenate([getattr(self, f), getattr(other, f)])
        for f in ("quanta_global_u", "quanta_global_l", "quanta_local_u", "quanta_local_l"):
            a, b = getattr(self, f), getattr(other, f)
            if a is not None and b is not None:
                cols[f] = np.concatenate([a, b])
        return LineList.from_columns(cols)


# ---------------------------------------------------------------------------
# Fixed-width .par parsing
# ---------------------------------------------------------------------------

def _parse_float_col(raw: np.ndarray, field: str = "") -> np.ndarray:
    """Vectorised float parse of a column of fixed-width byte fields.

    Blank fields parse as 0 (legitimate for optional columns like
    ``delta_air`` in older catalogs).  Non-numeric garbage FAILS LOUDLY
    with the record index and raw bytes — a malformed catalog must never
    silently zero a physics parameter (VERDICT r3 missing item 4).
    """
    s = np.char.strip(raw)
    s = np.where(s == b"", b"0", s)
    try:
        return s.astype(np.float64)
    except ValueError:
        for i, v in enumerate(s):
            try:
                float(v)
            except ValueError:
                raise ValueError(
                    f"malformed .par record {i}: field '{field}' contains "
                    f"non-numeric bytes {v!r}") from None
        raise


def _validate_required(cols: Dict[str, np.ndarray]) -> None:
    """nu0 and sw must be positive in every record: a blank/zero line
    center or intensity is a truncated or corrupted catalog, and blank->0
    would otherwise flow silently into the kernel (both engines: this runs
    AFTER the NumPy or C++ field extraction)."""
    for f in ("nu0", "sw"):
        bad = np.nonzero(~(cols[f] > 0.0))[0]
        if bad.size:
            raise ValueError(
                f"malformed .par record(s) {bad[:5].tolist()}"
                f"{'...' if bad.size > 5 else ''}: field '{f}' is blank, "
                f"zero, or negative in {bad.size} record(s) — refusing to "
                f"load a corrupted catalog")


def _attach_mass(cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Denormalise isotopologue mass per line for kernel consumption.

    Unknown (molecule, isotopologue) pairs FAIL LOUDLY (VERDICT.md round-1
    item 6): a guessed mass silently corrupts every Doppler width of that
    species, so it must never enter the kernel.  The registry covers the
    full HITRAN numbering (1-55); a legitimate new isotopologue belongs in
    :mod:`spectrobot_tpu_torch.data.molparams`.
    """
    mol_id = cols["mol_id"]
    iso_id = cols["iso_id"]
    n = len(mol_id)
    mass = np.zeros(n, dtype=np.float64)
    for m in np.unique(mol_id):
        mol = MOLECULES.get(int(m))
        for i in np.unique(iso_id[mol_id == m]):
            sel = (mol_id == m) & (iso_id == i)
            if mol is None or int(i) not in mol.isotopologues:
                raise KeyError(
                    f"unknown HITRAN species: molecule {int(m)} "
                    f"isotopologue {int(i)} ({int(sel.sum())} lines) — "
                    f"register it in spectrobot_tpu_torch.data.molparams")
            mass[sel] = mol.isotopologues[int(i)].mass_amu
    cols["mass_amu"] = mass
    return cols


def parse_par_text(text: str, use_native: str = "auto") -> LineList:
    """Parse the contents of a HITRAN ``.par`` file into a :class:`LineList`.

    use_native: "auto" (C++ parser when built), "never", or "always".
    """
    # Reject truncated records LOUDLY before either engine runs: the
    # minimum meaningful record covers through delta_air (67 chars); a
    # shorter non-blank line is a corrupted catalog, not a header (.par
    # files have none), and both parsers would otherwise skip it silently.
    # Vectorised (round-4 review): line lengths come from the newline
    # positions of the ALREADY-NEEDED latin-1 byte buffer — no Python
    # per-line loop, no splitlines() list on the native fast path.
    data = text.encode("latin-1")
    arr = np.frombuffer(data, dtype=np.uint8)
    nl = np.flatnonzero(arr == 0x0A)
    starts = np.concatenate(([0], nl + 1))
    ends = np.concatenate((nl, [len(arr)]))
    lengths = ends - starts
    nz = lengths > 0
    cr = np.zeros(len(lengths), dtype=bool)          # \r\n endings
    cr[nz] = arr[ends[nz] - 1] == 0x0D
    lengths = lengths - cr
    for i in np.flatnonzero(lengths < 67):           # rare: short lines only
        seg = data[starts[i]:ends[i]]
        if seg.strip():
            raise ValueError(
                f"malformed .par record at line {i + 1}: {lengths[i]} chars "
                f"(need >= 67 through delta_air; full records are 160) — "
                f"refusing to silently drop truncated records")
    if use_native in ("auto", "always"):
        from spectrobot_tpu_torch.data import hitran_native
        if hitran_native.available():
            cols = hitran_native.parse_par_bytes(data)
            _validate_required(cols)
            return LineList.from_columns(_attach_mass(cols))
        if use_native == "always":
            raise RuntimeError("native parser requested but not built "
                               "(run `make -C native`)")
    return _parse_records([ln for ln in text.splitlines() if ln.strip()])


def parse_par_file(path: str, use_native: str = "auto") -> LineList:
    with open(path, "r") as f:
        return parse_par_text(f.read(), use_native=use_native)


def _parse_records(records: List[str]) -> LineList:
    n = len(records)
    if n == 0:
        return LineList.from_columns({"nu0": np.zeros(0)})
    # Pad every record to 160 chars then view as a char matrix for vectorised
    # column slicing — this is the fast NumPy path; a C++ parser (native
    # data-loader tier) can replace it for very large catalogs.
    buf = np.array([r.ljust(160)[:160].encode("latin-1") for r in records])
    mat = buf.view("S1").reshape(n, 160)

    def col(a: int, b: int) -> np.ndarray:  # 1-based inclusive cols
        return mat[:, a - 1 : b].view(f"S{b - a + 1}").ravel()

    mol_id = _parse_float_col(col(1, 2)).astype(np.int32)
    # HITRAN isotopologue column: '1'-'9', '0' = 10, then letters 'A' = 11,
    # 'B' = 12, ... (extended codes; matches native/hitran_parser.cpp).
    iso_raw = np.char.strip(col(3, 3))
    iso_id = np.zeros(n, dtype=np.int32)
    iso_id[iso_raw == b"0"] = 10
    digit = np.char.isdigit(iso_raw) & (iso_raw != b"0")
    iso_id[digit] = iso_raw[digit].astype(np.int32)
    codes = iso_raw.view(np.uint8) if iso_raw.dtype.itemsize == 1 else None
    letter = np.char.isupper(iso_raw)
    iso_id[letter] = (iso_raw[letter].view(np.uint8).astype(np.int32)
                      - ord("A") + 11)

    cols: Dict[str, np.ndarray] = {
        "mol_id": mol_id,
        "iso_id": iso_id,
        "nu0": _parse_float_col(col(4, 15), "nu0"),
        "sw": _parse_float_col(col(16, 25), "sw"),
        "a_einstein": _parse_float_col(col(26, 35), "a_einstein"),
        "gamma_air": _parse_float_col(col(36, 40), "gamma_air"),
        "gamma_self": _parse_float_col(col(41, 45), "gamma_self"),
        "elower": _parse_float_col(col(46, 55), "elower"),
        "n_air": _parse_float_col(col(56, 59), "n_air"),
        "delta_air": _parse_float_col(col(60, 67), "delta_air"),
        "gp": _parse_float_col(col(147, 153), "gp"),
        "gpp": _parse_float_col(col(154, 160), "gpp"),
        "quanta_global_u": np.char.decode(col(68, 82), "latin-1"),
        "quanta_global_l": np.char.decode(col(83, 97), "latin-1"),
        "quanta_local_u": np.char.decode(col(98, 112), "latin-1"),
        "quanta_local_l": np.char.decode(col(113, 127), "latin-1"),
    }

    _validate_required(cols)
    return LineList.from_columns(_attach_mass(cols))


# ---------------------------------------------------------------------------
# Fixed-width .par WRITING (for fixtures and round-trip tests)
# ---------------------------------------------------------------------------

def _fit_fixed(x: float, width: int, prec: int) -> str:
    """Format ``x`` as fixed-point in exactly ``width`` chars (Fortran Fw.p)."""
    p = prec
    s = f"{x:{width}.{p}f}"
    while len(s) > width and p > 0:
        p -= 1
        s = f"{x:{width}.{p}f}"
    if len(s) > width:  # still too wide (huge magnitude) — truncate hard
        s = s[:width]
    return s


def format_par_record(
    mol_id: int, iso_id: int, nu0: float, sw: float, a: float,
    gamma_air: float, gamma_self: float, elower: float, n_air: float,
    delta_air: float, gq_u: str = "", gq_l: str = "", lq_u: str = "",
    lq_l: str = "", gp: float = 0.0, gpp: float = 0.0,
) -> str:
    rec = (
        f"{mol_id:2d}{iso_id:1d}"
        + _fit_fixed(nu0, 12, 6)
        + f"{sw:10.3E}{a:10.3E}"
        + _fit_fixed(gamma_air, 5, 4)
        + _fit_fixed(gamma_self, 5, 4)
        + _fit_fixed(elower, 10, 4)
        + _fit_fixed(n_air, 4, 2)
        + _fit_fixed(delta_air, 8, 6)
    )
    assert len(rec) == 67, len(rec)
    rec += gq_u.rjust(15)[:15] + gq_l.rjust(15)[:15]
    rec += lq_u.rjust(15)[:15] + lq_l.rjust(15)[:15]
    rec += " " * 18  # ierr/iref codes
    rec += " "       # line mixing flag
    rec += f"{gp:7.1f}{gpp:7.1f}"
    assert len(rec) == 160, len(rec)
    return rec
