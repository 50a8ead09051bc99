"""The inputs of a run, made from its seed: the configuration's line list
and atmosphere (written where the program reads them), the program's
configuration, the reference scene, and the traffic's pool of states.

The program receives only these generated inputs, through its own
configuration (``lines.source`` and ``scene.atmosphere`` name the files
written here); the reference reads the same arrays.  What belongs to one
scene (its catalog and atmosphere, the reference's coverage, the scene
itself) comes from the reference module its configuration's ``[bench]``
table names; the pool is drawn here, for every scene alike.
"""

from __future__ import annotations

import os
import tomllib
from types import ModuleType
from typing import NamedTuple

import numpy as np

from spectrobench import manifest

# Independent random streams of one seed.
STREAM_POOL, STREAM_NOISE, STREAM_ORDER, STREAM_CHECK = range(1, 5)


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of ``seed`` (any whole number >= 0)."""
    return np.random.default_rng([int(seed), stream])


def smooth_profiles(g: np.random.Generator, n: int, z: np.ndarray,
                    amplitude: float, modes: int) -> np.ndarray:
    """``n`` smooth profiles [n, n_lev] on altitudes ``z``: sums of
    ``modes`` sines of random phase and weight 1/k, each scaled so that its
    largest magnitude is ``amplitude`` times k / n for the k-th profile
    (k = 1..n), so every seed draws the same set of sizes in shapes of its
    own."""
    zn = (z - z[0]) / (z[-1] - z[0])
    out = np.zeros((n, z.shape[0]))
    for i in range(n):
        k = np.arange(1, modes + 1)[:, None]
        w = g.standard_normal((modes, 1)) / k
        phase = g.uniform(0.0, 2.0 * np.pi, (modes, 1))
        prof = (w * np.sin(np.pi * k * zn[None, :] + phase)).sum(0)
        out[i] = prof / np.abs(prof).max()
    sizes = amplitude * np.arange(1, n + 1) / n
    return out * g.permutation(sizes)[:, None]


class Inputs(NamedTuple):
    seed: int
    cfg: object               # the program's Config
    bench: dict               # the configuration's [bench] table
    traffic: dict             # the traffic mix's parameters
    ref: ModuleType           # the configuration's reference module
    scene: object             # the reference scene
    prior: dict               # the scene's prior: z, T, vmr [n_lev]
    pool: list                # per state: {"T": [n_lev], "vmr": [n_lev]}
    order: np.ndarray         # the pool's indices in the window's order


def read_config(path) -> dict:
    with open(path, "rb") as f:
        return tomllib.load(f)


def make_inputs(config_path, traffic: dict, seed: int, workdir: str,
                overrides=None) -> Inputs:
    """Write the seed's line list and the configuration's atmosphere under
    ``workdir`` and return the run's inputs.  ``overrides``: dotted
    configuration keys set over the file's (the tests' small scenes; a
    key ``bench.lines.n_lines`` sets the line list's length)."""
    from spectrobot_tpu_torch.config import load_config

    raw = read_config(config_path)
    bench = raw["bench"]
    overrides = dict(overrides or {})
    n_lines = overrides.pop("bench.lines.n_lines", None)
    if n_lines is not None:
        bench = {**bench, "lines": {**bench["lines"],
                                    "n_lines": int(n_lines)}}
    cfg = load_config(str(config_path), overrides)
    ref = manifest.reference(bench["reference"])
    ref.covers(cfg)
    lines, atm = ref.inputs(cfg, bench)
    os.makedirs(workdir, exist_ok=True)
    lines_path = os.path.join(workdir, "lines.npz")
    atm_path = os.path.join(workdir, "atmosphere.npz")
    np.savez(lines_path, **lines)
    np.savez(atm_path, **atm)
    cfg = load_config(str(config_path), {
        **overrides, "lines.source": lines_path,
        "scene.atmosphere": atm_path})
    scene = ref.configured_scene(cfg, lines, atm)
    prior = ref.prior(scene)
    # The pool's states: a fixed campaign where the mix fixes its seed
    # (every run then draws the same states, in an order of its own), else
    # the run's.
    g = rng(traffic.get("pool_seed", seed), STREAM_POOL)
    n = int(traffic["pool"])
    dT = smooth_profiles(g, n, prior["z"], traffic["t_perturb_k"],
                         traffic["modes"])
    dlnv = smooth_profiles(g, n, prior["z"],
                           traffic["vmr_perturb_ln"],
                           traffic["modes"])
    pool = [{"T": prior["T"] + dT[i], "vmr": prior["vmr"] * np.exp(dlnv[i])}
            for i in range(n)]
    order = rng(seed, STREAM_ORDER).permutation(n)
    return Inputs(int(seed), cfg, bench, traffic, ref, scene, prior, pool,
                  order)

