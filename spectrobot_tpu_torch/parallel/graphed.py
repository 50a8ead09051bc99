"""A rank's mesh body, or one card's Jacobian, replayed as one CUDA graph.

Eagerly, a nu-halo forward is issued from the host op by op: the exchange
of the line parameters, the own line sum (prologue and K1), the hop sums,
the ``line`` all-reduce and the epilogue.  On the card that is some 2 ms of
host issue for some 0.2 ms of device work, so the device is never
backlogged, and on the rank that arrives last the exchange runs with
nothing queued beside it.  XLA queues the reference's whole ``shard_map``
body at once, the permutes beside the local accumulation.

:class:`GraphedBody` does the same for a body of constants on the card.
At the first such call of an input key (the tensors' shapes, dtypes and
devices, and every other argument) it runs the body eagerly (which also
makes NCCL's communicators and readies the mesh's capture ring) and then
captures it into one ``torch.cuda.CUDAGraph``, the body's exchange forked
onto a stream of its own (``collectives.ring_exchange_start(stream=)``)
and sent by the port's ring kernel over ``Mesh.capture_ring``, not by
NCCL: in the graph the exchange and the own line sum are independent
branches, joined before the hop sums.  Every later call of that key
copies its inputs into the graph's static inputs, replays the graph once
and returns a copy of its output; the device starts both branches at the
replay, whatever the host does.  (A captured NCCL send/receive started
only after the own line sum: NCCL's support of graphs mixed with eager
calls holds it back, and NCCL 2.28 offers no switch for it per
communicator, only a process-wide environment variable.)

The single-card Jacobian (``retrieval.state.jacobian_graphed``) takes the
same route through a body with no exchange (it ignores ``side``): the whole
``torch.func.jacfwd`` of a flat forward, path, prologue, K1, K2, the
vmapped epilogue and the ILS, issued by one graph launch where the host
issued it op by op, and its forward's spans recorded as timing events in
the graph (``spans=True``; ``utils.profiling.capturing_spans``).

The route is chosen by the inputs alone (:func:`graph_route`): tensors on
the card, none a ``torch.func`` wrapper, a ``requires_grad`` leaf or a
forward-AD dual, and no transform active.  Anything else (the mesh
Jacobian under ``torch.func.jacfwd``, autograd, the CPU and gloo) runs the
body eagerly.  A capture or replay error raises.  Every rank must capture
at the same call: the mesh's callers run the forward in lockstep.

The kernels' launch counts move at capture but no kernel runs then: the
capture's increments are taken back and added again at every replay, so a
count says how many launches the device ran; :func:`kernel_launches` reads
the same counts from a profiler trace, which is how the tools check them.
Replays of one graph run in stream order and never overlap: K3's arrival
counters, which its wrapper caches per stream, are allocated and zeroed
inside the capture, and the graph takes them out of that cache
(:func:`take_stream_caches`), so that no other graph or call on a recycled
stream handle shares them.

The capture ring's launches are counted on the card (each replay's ring
kernel runs the next epoch of its ring), so every rank must replay the
graphs of a mesh in the same order, as the SPMD callers do.  A replay's
ring kernel waits for its neighbours' and traps ``parallel.peer.TIMEOUT_S``
(5 s) after its wait began.  The callers stay inside it: each replay is
queued on the current stream behind the rank's earlier collectives (the
previous forward's ``line`` all-reduce and all-gather, the normal
equations' all-reduces, which no rank passes before every rank has issued
them), so a ring kernel waits only for the host work the ranks do between
their last common collective and the replay, the same on every rank (an LM
step's solve, a profiler window's start); what one rank alone does (rank
0 writing the outputs) comes after a run's last forward.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, List, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from spectrobot_tpu_torch.parallel.collectives import is_constant
from spectrobot_tpu_torch.utils.profiling import (
    annotate, capturing_spans, replayed_spans)

# The profiler range around a replay (``halo_overlap``'s host marks).
REPLAY_RANGE = "mesh_graph_replay"
# Every kernel wrapper's launch count, as (module, attribute), and the
# __global__ whose launches it counts (a trace's kernels are named so).
COUNTERS = {("cuda_opacity", "LAUNCHES"): "opacity_batch_kernel",
            ("cuda_basis", "LAUNCHES"): "basis_batch_kernel",
            ("cuda_transpose", "LAUNCHES"): "basis_transpose_kernel",
            ("cuda_single", "LAUNCHES"): "opacity_single_kernel",
            ("cuda_basis_single", "LAUNCHES"): "basis_single_kernel",
            ("cuda_fma", "LAUNCHES"): "fma_chain_kernel",
            ("cuda_dma", "RING_LAUNCHES"): "dma_ring_kernel",
            ("cuda_dma", "HALO_LAUNCHES"): "dma_halo_kernel",
            ("cuda_epilogue", "LAUNCHES"): "rt_epilogue_kernel"}
# The wrappers' per-stream caches of arrival counters, {(device, raw
# stream handle): tensor}, as (module, attribute).
STREAM_CACHES = (("cuda_single", "_COUNTERS"), ("cuda_transpose", "_COUNTERS"),
                 ("cuda_dma", "_COUNTERS"))


def _counter_modules() -> list:
    """(module, attribute) of every launch count (imported here, not at
    module import: ``ops.cuda_dma`` imports ``parallel.halo``)."""
    import importlib
    return [(importlib.import_module(f"spectrobot_tpu_torch.ops.{m}"), a)
            for m, a in COUNTERS]


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, by ``module.attribute``."""
    return {f"{m.__name__.rsplit('.', 1)[1]}.{a}": getattr(m, a)
            for m, a in _counter_modules()}


def kernel_launches(names: Sequence[str]) -> Dict[str, int]:
    """The launches of each counted kernel among the device events named
    ``names`` (a profiler trace), by :func:`launch_counts`' names."""
    return {f"{m}.{a}": sum(kernel in n for n in names)
            for (m, a), kernel in COUNTERS.items()}


def take_stream_caches(streams: Sequence[torch.cuda.Stream]) -> list:
    """Take the arrival counters the wrappers cache for ``streams`` out of
    their caches (``STREAM_CACHES``) and return them."""
    import importlib
    handles = {s.cuda_stream for s in streams}
    taken = []
    for m, a in STREAM_CACHES:
        cache = getattr(importlib.import_module(
            f"spectrobot_tpu_torch.ops.{m}"), a)
        taken += [cache.pop(k) for k in list(cache) if k[1] in handles]
    return taken


def add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta`` (as :func:`launch_counts` names them) to the counts."""
    for m, a in _counter_modules():
        k = f"{m.__name__.rsplit('.', 1)[1]}.{a}"
        setattr(m, a, getattr(m, a) + delta.get(k, 0))


def constant_call(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether these input tensors make a call of constants: no
    ``torch.func`` transform active and every one a constant
    (``collectives.is_constant``: no wrapper, ``requires_grad`` or
    forward-AD tangent)."""
    return (torch._C._functorch.maybe_current_level() is None
            and all(is_constant(t) for t in tensors))


def graph_route(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether a call of these input tensors replays a graph: a
    :func:`constant_call` of tensors all on the card, outside any capture
    under way."""
    return (len(tensors) > 0 and all(t.is_cuda for t in tensors)
            and constant_call(tensors)
            and not torch.cuda.is_current_stream_capturing())


class _Graph:
    """One captured body: its static inputs, graph, output, the arrival
    counters its kernels use, the launches of one replay, the memory the
    capture took and the spans it met (``utils.profiling.capturing_spans``;
    with ``spans`` false, none are kept)."""

    def __init__(self, body: Callable, leaves: list, spec,
                 spans: bool = False):
        dev = next(t for t in leaves if isinstance(t, torch.Tensor)).device
        static = [t.clone() if isinstance(t, torch.Tensor) else t
                  for t in leaves]
        self.inputs = [t for t in static if isinstance(t, torch.Tensor)]
        args, kwargs = tree_unflatten(static, spec)
        self.graph = torch.cuda.CUDAGraph()
        stream, side = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        before = launch_counts()
        # The capture empties the allocator's cache first; so does this, so
        # that the growth of the reserved memory is the graph's own pool.
        torch.cuda.synchronize(dev)
        # Counters cached for a recycled stream handle are not this graph's.
        take_stream_caches((stream, side))
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        with contextlib.ExitStack() as stack:
            self.spans = (stack.enter_context(capturing_spans()) if spans
                          else ())
            stack.enter_context(torch.cuda.graph(
                self.graph, stream=stream, capture_error_mode="thread_local"))
            self.out = body(*args, **kwargs, side=side)
        # The counters the capture allocated (and zeroes at every replay)
        # are the graph's own: no later call on these handles may share them.
        self.counters = take_stream_caches((stream, side))
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        add_launches({k: -n for k, n in self.launches.items()})
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def replay(self, tensors: List[torch.Tensor]):
        with annotate(REPLAY_RANGE):
            torch._foreach_copy_(self.inputs, tensors)
            self.graph.replay()
            add_launches(self.launches)
            replayed_spans(self.spans)
            return tree_map(torch.clone, self.out)


class GraphedBody:
    """``body(*args, side=None, **kwargs)`` (``side``: the stream its
    exchange is issued from, None eagerly) called through one CUDA graph
    per input key where :func:`graph_route` allows it, eagerly otherwise
    (the module docstring).  With ``spans`` each replay made while a
    profiler runs records the spans its capture met
    (``utils.profiling.replayed_spans``).  ``graphs``: the captured graphs
    by key; ``replays``: how many calls replayed one."""

    def __init__(self, body: Callable, spans: bool = False):
        self.body = body
        self.spans = spans
        self.graphs: Dict[tuple, _Graph] = {}
        self.replays = 0
        _BODIES.add(self)

    def release(self) -> None:
        """Drop every captured graph (the next call of a key captures
        anew)."""
        for g in self.graphs.values():
            g.graph.reset()
        self.graphs.clear()

    def __call__(self, *args, **kwargs):
        leaves, spec = tree_flatten((args, kwargs))
        tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
        if not graph_route(tensors):
            return self.body(*args, **kwargs)
        key = (spec, tuple((tuple(t.shape), t.dtype, t.device)
                           if isinstance(t, torch.Tensor) else t
                           for t in leaves))
        graph = self.graphs.get(key)
        if graph is None:
            out = self.body(*args, **kwargs)
            self.graphs[key] = _Graph(self.body, leaves, spec,
                                      spans=self.spans)
            return out
        self.replays += 1
        return graph.replay(tensors)


# Every live GraphedBody, for release_graphs.
_BODIES: "weakref.WeakSet[GraphedBody]" = weakref.WeakSet()


def pool_bytes() -> int:
    """The device memory the captures of every live :class:`GraphedBody`
    took (each graph's private pool)."""
    return sum(g.pool_bytes for body in list(_BODIES)
               for g in body.graphs.values())


def release_graphs() -> None:
    """Drop the captured graphs of every live :class:`GraphedBody`: a
    graph holds NCCL's kernels, and ending the process group waits for
    such graphs to go (``parallel.mesh.finalize_multihost``)."""
    for body in list(_BODIES):
        body.release()
