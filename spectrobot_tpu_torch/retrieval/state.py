"""Retrieval state vector and forward-model builder (port of
``spectrobot_tpu.retrieval.state``).

The state is a dict ``{"T": [n_lev], "T_surface": [], "ln_vmr": {species:
[n_lev]}}`` flattened in the reference's ``ravel_pytree`` order ("T", then
"T_surface", then "ln_vmr" by sorted species), so one flat vector means the
same thing in both packages.  The forward model is one function state -> y
(concatenated channel radiances over all rays), differentiable in forward
mode: :func:`jacobian_fwd` is ``torch.func.jacfwd``, whose tangent batch the
line sum folds into one basis-kernel call (``ops.opacity.LineSumOp``), and
:func:`jacobian_graphed` the same Jacobian replayed from one CUDA graph on
the card.  With
``analytic_jvp='rev'`` it is differentiable in reverse mode instead: the
gradient of a retrieval cost costs one transpose-kernel call.  A non-LTE
state, a collision-induced continuum and a field of view (a fine ladder of
limb rays smeared into the observed ones) are options of the forward.
:func:`build_forward_lut` is the same forward through a (P, T) table
(``ops.lut``): no line sum per call.
"""

from __future__ import annotations

import itertools
import math
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from spectrobot_tpu_torch.data.atmosphere import Atmosphere, Planet
from spectrobot_tpu_torch.forward.geometry import limb_path_cg, nadir_path_cg
from spectrobot_tpu_torch.forward.limb import (
    layer_tau_kernel, radiance_from_tau)
from spectrobot_tpu_torch.ops.cuda_basis import KERNELS
from spectrobot_tpu_torch.ops.cuda_opacity import line_windows
from spectrobot_tpu_torch.ops.ils import apply_fov, apply_ils
from spectrobot_tpu_torch.ops.opacity import Engine, ad_mode
from spectrobot_tpu_torch.ops.strengths import DeviceLines
from spectrobot_tpu_torch.parallel.graphed import GraphedBody, pool_bytes
from spectrobot_tpu_torch.utils.profiling import annotate


def make_state(atm: Atmosphere, retrieve_vmr: Sequence[str],
               T_surface: Optional[float] = None,
               retrieve_temperature: bool = True) -> Dict:
    """Initial state from an atmosphere: its T profile (unless
    ``retrieve_temperature=False``) and the log-VMR profiles of the
    retrieved species (log keeps VMRs positive under LM steps).  Pass
    ``T_surface`` to also retrieve the surface temperature (nadir)."""
    state: Dict = {"ln_vmr": {s: torch.log(atm.vmr[s])
                              for s in retrieve_vmr}}
    if retrieve_temperature:
        state["T"] = atm.T
    if T_surface is not None:
        state["T_surface"] = torch.as_tensor(T_surface, dtype=atm.T.dtype,
                                             device=atm.T.device)
    return state


def apply_state(atm: Atmosphere, state: Dict) -> Atmosphere:
    out = atm.with_temperature(state["T"]) if "T" in state else atm
    for s, lv in state["ln_vmr"].items():
        out = out.with_vmr(s, torch.exp(lv))
    return out  # (surface parameters are consumed by the forward)


def node_level_matrix(z_lev: np.ndarray, z_nodes: np.ndarray) -> np.ndarray:
    """[n_lev, n_nodes] piecewise-linear interpolation matrix: profile at
    the model levels = M @ profile at the retrieval nodes (hat functions,
    constant extrapolation beyond the end nodes: ``np.interp`` as a
    matrix)."""
    z_lev = np.asarray(z_lev, np.float64)
    z_nodes = np.asarray(z_nodes, np.float64)
    if z_nodes.ndim != 1 or len(z_nodes) < 2:
        raise ValueError("need at least 2 retrieval nodes")
    if not np.all(np.diff(z_nodes) > 0):
        raise ValueError("retrieval node altitudes must be strictly "
                         "increasing")
    n_lev, n_nodes = len(z_lev), len(z_nodes)
    M = np.zeros((n_lev, n_nodes))
    j = np.clip(np.searchsorted(z_nodes, z_lev, side="right") - 1, 0,
                n_nodes - 2)
    t = np.clip((z_lev - z_nodes[j]) / (z_nodes[j + 1] - z_nodes[j]),
                0.0, 1.0)
    M[np.arange(n_lev), j] = 1.0 - t
    M[np.arange(n_lev), j + 1] += t
    return M


class NodeBasis:
    """Linear node -> level map for a retrieval on a coarse altitude grid.

    ``expand(state)`` maps a node-space state (profiles of length n_nodes)
    to the level-space state the forward consumes; T_surface passes
    through.  Compose as ``forward(expand(state))``.
    """

    def __init__(self, z_lev, z_nodes):
        self.z_lev = np.asarray(z_lev, np.float64)
        self.z_nodes = np.asarray(z_nodes, np.float64)
        # Host float64 master copy, staged in the state's dtype and device
        # at its first expand (none after: a host copy stops a CUDA graph's
        # capture).
        self.M = node_level_matrix(self.z_lev, self.z_nodes)
        self.n_nodes = int(self.M.shape[1])
        self._staged: Dict[tuple, torch.Tensor] = {}

    @classmethod
    def uniform(cls, atm: Atmosphere, n_nodes: int) -> "NodeBasis":
        z = atm.z.detach().cpu().numpy().astype(np.float64)
        return cls(z, np.linspace(z[0], z[-1], int(n_nodes)))

    def init_state(self, atm: Atmosphere, retrieve_vmr: Sequence[str],
                   T_surface: Optional[float] = None,
                   retrieve_temperature: bool = True) -> Dict:
        """Node-space initial state: the atmosphere's profiles sampled at
        the node altitudes."""
        state: Dict = {"ln_vmr": {s: self.project(torch.log(atm.vmr[s]))
                                  for s in retrieve_vmr}}
        if retrieve_temperature:
            state["T"] = self.project(atm.T)
        if T_surface is not None:
            state["T_surface"] = torch.as_tensor(
                T_surface, dtype=atm.T.dtype, device=atm.T.device)
        return state

    def project(self, profile_lev: torch.Tensor) -> torch.Tensor:
        """Level profile -> node values (sampled at the node altitudes)."""
        v = np.interp(self.z_nodes, self.z_lev,
                      profile_lev.detach().cpu().numpy().astype(np.float64))
        return torch.as_tensor(v, dtype=profile_lev.dtype,
                               device=profile_lev.device)

    def expand(self, state: Dict) -> Dict:
        def up(v):
            M = self._staged.get((v.dtype, v.device))
            if M is None:
                M = self._staged[v.dtype, v.device] = torch.as_tensor(
                    self.M, dtype=v.dtype, device=v.device)
            return M @ v
        out: Dict = {"ln_vmr": {s: up(v) for s, v in state["ln_vmr"].items()}}
        if "T" in state:
            out["T"] = up(state["T"])
        if "T_surface" in state:
            out["T_surface"] = state["T_surface"]
        return out


def build_forward(
    base_atm: Atmosphere,
    lines: DeviceLines,
    nu_grid: torch.Tensor,
    species: Sequence[str],
    planet: Planet,
    tangent_heights_m: Optional[torch.Tensor] = None,
    sec_theta: Optional[torch.Tensor] = None,
    T_surface: Optional[float] = None,
    emissivity: float = 1.0,
    ils_W: Optional[torch.Tensor] = None,
    fov_V: Optional[torch.Tensor] = None,
    nlte=None,
    n_sub: int = 4,
    *,
    cutoff_cm1: Optional[float] = 25.0,
    nu_off: Optional[torch.Tensor] = None,
    engine: Engine = KERNELS,
    windows=None,
    analytic_jvp=True,
    cia=None,
    chi=None,
    depths_tap: Optional[Callable] = None,
) -> Callable[[Dict], torch.Tensor]:
    """Build F: state -> y (the port's counterpart of the reference's
    ``build_forward`` on its single-device line-by-line path).

    Limb mode when ``tangent_heights_m`` is given (deep space behind), nadir
    when ``sec_theta`` is (grey surface at ``T_surface``, or the state's
    "T_surface").  ``ils_W`` maps the fine grid to instrument channels;
    ``fov_V`` [n_obs, n_ray] smears the ray ladder ``tangent_heights_m``
    into the observed fields of view (``ops.ils.fov_matrix``), before the
    ILS.  ``nlte`` (``data.nlte.DeviceNLTE``): the non-LTE state;
    ``cia`` (``ops.cia.DeviceCIA``): the collision-induced continuum.
    ``nu_off``: the grid in offset coordinates (default: staged from
    float64 here); ``windows``: the scene's window table (default: built
    once here).  ``engine``: ``ops.cuda_basis.KERNELS``, ``PLAIN`` or
    ``WEIDEMAN``.
    ``analytic_jvp``: True/'fwd' (forward mode: ``torch.func.jacfwd``),
    'rev' (reverse mode: ``torch.autograd.grad``, ``torch.func.jacrev``) or
    False (plain autograd), as ``forward.limb.layer_tau_kernel`` takes it.
    ``chi`` = (``ops.chi.ChiProfile``, row_mask): the sub-Lorentzian wing
    correction.  ``depths_tap(cg, dtau)``, if given, receives each call's
    path and layer absorption depths [R, NL, P] straight from the line sum
    (the CLI's ``run.save_optics`` reuses them; no second line sum).
    Output y is flattened [n_obs_ray * n_chan].  Each call's phases run in
    the spans (``utils.profiling.annotate``) ``spectrobot.forward.path``,
    ``.prologue``, ``.line_sum``, ``.epilogue`` (the FOV included) and
    ``.ils``.
    """
    if nu_off is None:
        nu_off = torch.as_tensor(
            nu_grid.detach().cpu().double().numpy()
            - float(lines.nu_ref), dtype=nu_grid.dtype,
            device=nu_grid.device)
    if windows is None and ad_mode(analytic_jvp) is not None:
        windows = line_windows(nu_off, lines.nu0, cutoff_cm1=cutoff_cm1)

    def forward(state: Dict) -> torch.Tensor:
        with annotate("spectrobot.forward.path"):
            atm = apply_state(base_atm, state)
            if tangent_heights_m is not None:
                cg = limb_path_cg(atm, species, tangent_heights_m, planet,
                                  n_sub)
                ts = None
            else:
                cg = nadir_path_cg(atm, species, sec_theta, n_sub)
                ts = state.get("T_surface", T_surface)
        dtau, dtau_em = layer_tau_kernel(nu_off, lines, cg, windows,
                                         cutoff_cm1=cutoff_cm1,
                                         engine=engine,
                                         analytic_jvp=analytic_jvp, chi=chi,
                                         nlte=nlte)
        if depths_tap is not None:
            depths_tap(cg, dtau)
        with annotate("spectrobot.forward.epilogue"):
            I = radiance_from_tau(nu_grid.to(dtau.dtype), cg, dtau, dtau_em,
                                  cia=cia, T_surface=ts,
                                  emissivity=emissivity)
            if fov_V is not None:
                I = apply_fov(I, fov_V)
        if ils_W is not None:
            with annotate("spectrobot.forward.ils"):
                I = apply_ils(I, ils_W)
        return I.reshape(-1)

    return forward


def build_forward_lut(
    base_atm: Atmosphere,
    lut,
    species: Sequence[str],
    planet: Planet,
    tangent_heights_m: Optional[torch.Tensor] = None,
    sec_theta: Optional[torch.Tensor] = None,
    T_surface: Optional[float] = None,
    emissivity: float = 1.0,
    ils_W: Optional[torch.Tensor] = None,
    fov_V: Optional[torch.Tensor] = None,
    nlte=None,
    n_sub: int = 4,
    cia=None,
) -> Callable[[Dict], torch.Tensor]:
    """Build F: state -> y through the (P, T) table runtime (the reference's
    ``build_forward_lut``): the bilinear interpolation is differentiable in
    (T, log p) and in the VMR state, so ``torch.func.jacfwd`` gives the
    Jacobian with no line sum per call.  ``lut``: an ``ops.lut.OpacityLUT``
    or ``NLTELUT`` (with ``nlte``, whose populations contract against the
    tables).  The other arguments as :func:`build_forward`."""
    from spectrobot_tpu_torch.ops.lut import table_depths

    nu_grid = lut.nu_grid

    def forward(state: Dict) -> torch.Tensor:
        atm = apply_state(base_atm, state)
        if tangent_heights_m is not None:
            cg = limb_path_cg(atm, species, tangent_heights_m, planet, n_sub)
            ts = None
        else:
            cg = nadir_path_cg(atm, species, sec_theta, n_sub)
            ts = state.get("T_surface", T_surface)
        dtau, dtau_em = table_depths(lut, cg, nlte)
        I = radiance_from_tau(nu_grid.to(dtau.dtype), cg, dtau, dtau_em,
                              cia=cia, T_surface=ts, emissivity=emissivity)
        if fov_V is not None:
            I = apply_fov(I, fov_V)
        if ils_W is not None:
            I = apply_ils(I, ils_W)
        return I.reshape(-1)

    return forward


def flatten_state(state: Dict) -> Tuple[torch.Tensor, Callable]:
    """state <-> flat vector, in the reference's ``ravel_pytree`` order
    (dict keys sorted: "T", "T_surface", "ln_vmr"; species sorted)."""
    keys = [(k,) for k in sorted(state) if k != "ln_vmr"]
    keys += [("ln_vmr", s) for s in sorted(state.get("ln_vmr", {}))]

    def leaf(k):
        return state[k[0]] if len(k) == 1 else state[k[0]][k[1]]

    leaves = [leaf(k) for k in keys]
    shapes = [tuple(v.shape) for v in leaves]
    sizes = [int(np.prod(s)) for s in shapes]
    flat = (torch.cat([v.reshape(-1) for v in leaves]) if leaves
            else torch.zeros(0))

    def unravel(x: torch.Tensor) -> Dict:
        out: Dict = {"ln_vmr": {}}
        for k, shape, part in zip(keys, shapes, torch.split(x, sizes)):
            if len(k) == 1:
                out[k[0]] = part.reshape(shape)
            else:
                out["ln_vmr"][k[1]] = part.reshape(shape)
        return out

    return flat, unravel


def jacobian_fwd(forward_flat: Callable, x: torch.Tensor) -> torch.Tensor:
    """Analytic Jacobian K [n_y, n_x] by forward-mode AD, in the span
    ``spectrobot.jacobian``."""
    with annotate("spectrobot.jacobian"):
        return torch.func.jacfwd(forward_flat)(x)


# The captures and replays of the Jacobian's CUDA graphs over the process
# (jacobian_graphed), beside ``retrieval.oe.COUNTS``' Jacobians; the
# benchmark's ``jacobian_graph_pct`` reads them.
GRAPH_COUNTS = {"jacobian_graph_captures": 0, "jacobian_graph_replays": 0}
# The graphed Jacobian body of each flat forward (jacobian_graphed), kept
# while the forward lives, and the order in which the bodies were last
# called (release_jacobian_graphs releases the oldest first).
_GRAPHED: "weakref.WeakKeyDictionary[Callable, GraphedBody]" = (
    weakref.WeakKeyDictionary())
_LAST_CALL: "weakref.WeakKeyDictionary[GraphedBody, int]" = (
    weakref.WeakKeyDictionary())
_CALLS = itertools.count()


def _held(body: GraphedBody) -> int:
    return sum(g.pool_bytes for g in body.graphs.values())


def release_jacobian_graphs(budget: Optional[float] = None,
                            keep: Optional[GraphedBody] = None) -> None:
    """Release the Jacobians' graphs (:func:`jacobian_graphed`), the least
    recently called forward's first and never ``keep``'s, until the pools
    of every live graph (``parallel.graphed.pool_bytes``, the mesh bodies'
    included) less ``keep``'s come to ``budget`` bytes or less; with no
    budget, all of them.  A released forward's next Jacobian captures
    again."""
    own = 0 if keep is None else _held(keep)
    for body in sorted((b for b in list(_GRAPHED.values())
                        if b.graphs and b is not keep),
                       key=lambda b: _LAST_CALL.get(b, -1)):
        if budget is not None and pool_bytes() - own <= budget:
            return
        body.release()


def jacobian_graphed(forward_flat: Callable, nbytes: float = 0.0,
                     limit: float = math.inf) -> Callable:
    """The Jacobian of :func:`jacobian_fwd`, through one CUDA graph per
    key (x's shape, dtype and device, and the float32 matmul precision)
    where ``parallel.graphed.graph_route`` allows it: on the card, outside
    any transform and with x not requiring grad.  There the first call of
    a key runs ``jacfwd`` eagerly and then captures it, and every later
    call, through any callable this returns for the same ``forward_flat``,
    copies x into the graph, replays it and returns a copy of K: the
    kernels and their order as eagerly, issued by one launch.  Elsewhere
    ``jacfwd`` runs eagerly.  Each call is one span ``spectrobot.jacobian``
    that holds the forward's phases, a replay's from the events its
    capture recorded.  :data:`GRAPH_COUNTS` counts the captures and
    replays.  The graphs go with ``forward_flat`` (held weakly here, and by
    the callable returned); the tensors it closes over must keep their
    storage while it lives, as a scene's do.

    The graphs' pools stay reserved, so the Jacobian memory of the device
    is what every graph holds plus the Jacobian that runs.  Before each
    call, the other forwards' Jacobian graphs are released, the least
    recently called first, until the pools of the rest plus this
    Jacobian's (its own pool, or ``nbytes`` before its capture: the
    counted bytes of ``cli.jacobian_bytes``) come to ``limit`` or less
    (``cli.jacobian_limit``, the guard's): callers that alternate between
    forwards keep each one's graph while they fit."""

    def jacobian(x: torch.Tensor) -> torch.Tensor:
        body = _GRAPHED.get(forward_flat)
        if body is None:
            ref = weakref.ref(forward_flat)
            body = _GRAPHED[forward_flat] = GraphedBody(
                lambda x, _precision, side=None: torch.func.jacfwd(ref())(x),
                spans=True)
        _LAST_CALL[body] = next(_CALLS)
        release_jacobian_graphs(limit - max(_held(body), nbytes), keep=body)
        n_graphs, n_replays = len(body.graphs), body.replays
        with annotate("spectrobot.jacobian"):
            K = body(x, torch.get_float32_matmul_precision())
        counts = GRAPH_COUNTS
        counts["jacobian_graph_captures"] += len(body.graphs) - n_graphs
        counts["jacobian_graph_replays"] += body.replays - n_replays
        return K

    return jacobian


def jacobian_fwd_chunked(forward_flat: Callable, x: torch.Tensor,
                         chunk: int = 16) -> torch.Tensor:
    """The Jacobian in tangent chunks: a vmap of ``torch.func.jvp`` over
    ``chunk`` columns of the identity at a time, which bounds the live
    tangent batch (``torch.func.jacfwd`` has no chunk size).  Same result
    as :func:`jacobian_fwd`, in one span ``spectrobot.jacobian`` that holds
    the chunks.  It runs eagerly, after the Jacobians' graphs are released
    (:func:`release_jacobian_graphs`): it is taken where one Jacobian would
    not fit beside them."""
    release_jacobian_graphs()
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)

    def one(v):
        return torch.func.jvp(forward_flat, (x,), (v,))[1]

    with annotate("spectrobot.jacobian"):
        cols = [torch.func.vmap(one)(eye[s:s + chunk])
                for s in range(0, x.shape[0], chunk)]
        return torch.cat(cols, dim=0).T


def jacobian_fd(forward_flat: Callable, x: torch.Tensor,
                eps: float = 1e-3) -> np.ndarray:
    """Central finite-difference Jacobian (the reference's config-4
    cross-check harness); eps is scaled per parameter by max(|x_i|, 1)."""
    x_host = x.detach().cpu().numpy()
    dev = lambda v: torch.as_tensor(v, dtype=x.dtype, device=x.device)
    cols = []
    for i in range(x_host.shape[0]):
        h = eps * max(abs(float(x_host[i])), 1.0)
        xp = x_host.copy()
        xp[i] += h
        xm = x_host.copy()
        xm[i] -= h
        cols.append((forward_flat(dev(xp)) - forward_flat(dev(xm)))
                    .detach().cpu().numpy().astype(np.float64) / (2 * h))
    return np.stack(cols, axis=1)
