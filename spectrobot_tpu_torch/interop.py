"""Carry state from the JAX package into the port.

Each function takes one of the reference's structures given as a dict of
numpy arrays, e.g. ``{k: np.asarray(v) for k, v in dl._asdict().items()}``,
and returns the port's structure on ``device`` with the same dtypes (index
arrays become int64).  Nothing here imports jax, so the port's tests can
feed both packages identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from spectrobot_tpu_torch.data.atmosphere import Atmosphere
from spectrobot_tpu_torch.forward.geometry import PathCG
from spectrobot_tpu_torch.ops.strengths import DeviceLines
from spectrobot_tpu_torch.retrieval.state import NodeBasis, flatten_state

_INDEX_FIELDS = ("species_idx", "level_upper", "level_lower", "seg_layer")


def _tensor(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if name in _INDEX_FIELDS:
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)   # a copy: jax arrays are read-only


def device_lines_from_numpy(d: dict, *, device) -> DeviceLines:
    """DeviceLines from the reference's DeviceLines fields."""
    return DeviceLines(**{k: _tensor(k, d[k], device)
                          for k in DeviceLines._fields})


def path_cg_from_numpy(d: dict, *, device) -> PathCG:
    """PathCG from the reference's PathCG fields (``seg_count`` and
    ``is_limb`` as 0-d arrays or python scalars; absent or None CIA columns
    stay None)."""
    out = {}
    for k in PathCG._fields:
        v = d.get(k)
        if k == "seg_count":
            out[k] = int(v)
        elif k == "is_limb":
            out[k] = bool(v)
        elif v is None or (isinstance(v, np.ndarray) and v.dtype == object):
            out[k] = None
        else:
            out[k] = _tensor(k, v, device)
    return PathCG(**out)


def atmosphere_from_numpy(d: dict, *, device) -> Atmosphere:
    """Atmosphere from {"z", "p", "T", "n": arrays, "vmr": {name: array}}."""
    return Atmosphere.from_numpy(d["z"], d["p"], d["T"], d["n"], d["vmr"],
                                 device=device)


def state_from_numpy(flat, template: dict) -> dict:
    """The port's retrieval state holding the reference's flat state vector
    ``flat`` (``ravel_pytree`` order, the same as
    ``retrieval.state.flatten_state``), with the structure, dtype and device
    of the port's state ``template``."""
    x0, unravel = flatten_state(template)
    flat = np.asarray(flat)
    if flat.shape != tuple(x0.shape):
        raise ValueError(f"flat state has shape {flat.shape}, the template "
                         f"{tuple(x0.shape)}")
    return unravel(torch.as_tensor(flat, dtype=x0.dtype, device=x0.device))


def node_basis_from_numpy(M, z_lev, z_nodes) -> NodeBasis:
    """The port's NodeBasis carrying the reference's node -> level matrix
    ``M`` [n_lev, n_nodes] exactly, on the same altitude grids."""
    nb = NodeBasis(z_lev, z_nodes)
    M = np.asarray(M, np.float64)
    if M.shape != nb.M.shape:
        raise ValueError(f"M has shape {M.shape}, the grids give "
                         f"{nb.M.shape}")
    nb.M = M.copy()
    return nb
