"""Line lists of the port's scenes, made by the port's copies of the
reference's host modules (``data.synth``, ``data.hitran``): the list a TOML
configuration names, and the random band of the reference's throughput
bench."""

from __future__ import annotations

from spectrobot_tpu_torch.data import synth
from spectrobot_tpu_torch.data.hitran import LineList, parse_par_file
from spectrobot_tpu_torch.data.synth import random_lines

__all__ = ["configured_lines", "random_lines"]

_SYNTHETIC = {
    "co2_15um": synth.co2_15um_band,
    "co2_43um": synth.co2_43um_band,
    "co2_43um_hot": synth.co2_43um_hot_band,
    "co_fundamental": synth.co_fundamental,
    "h2o": synth.h2o_band,
}


def configured_lines(cfg) -> LineList:
    """The configured line list, selected to the grid (a copy of the
    reference CLI's ``_build_lines``)."""
    src = cfg.lines.source
    if src.startswith("synthetic:"):
        ll = None
        for name in src.split(":", 1)[1].split(","):
            part = _SYNTHETIC[name.strip()]()
            ll = part if ll is None else ll.concat(part)
    elif src.endswith(".npz"):
        ll = LineList.load_npz(src)
    else:
        ll = parse_par_file(src)
    return ll.select(nu_min=cfg.grid.nu_min, nu_max=cfg.grid.nu_max,
                     wing_cm1=cfg.lines.wing_cm1, min_sw=cfg.lines.min_sw)
