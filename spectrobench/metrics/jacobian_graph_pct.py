"""jacobian_graph_pct [%]: the share of the LM loop's Jacobians that
replayed a CUDA graph: 100 x ``jacobian_graph_replays`` of the program's
graph counts (``spectrobot_tpu_torch.retrieval.state.GRAPH_COUNTS``) over
``jacobians`` of its LM counts (``retrieval.oe.COUNTS``), over the run's
whole process (set-up's warm unit, whose first Jacobian captures the
graph, included).  None where the program keeps no graph counts."""


def read(rec):
    if not rec.get("units"):
        return None
    from spectrobot_tpu_torch.retrieval import oe, state
    counts = getattr(oe, "COUNTS", None)
    graphs = getattr(state, "GRAPH_COUNTS", None)
    if not counts or not graphs or not counts["jacobians"]:
        return None
    return 100.0 * graphs["jacobian_graph_replays"] / counts["jacobians"]
