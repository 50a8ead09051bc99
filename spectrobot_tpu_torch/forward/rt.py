"""Line-of-sight radiative-transfer integrator (port of
``spectrobot_tpu.forward.rt.layer_path_radiance``, in its gather + cumsum
form).

Emission-only RT along a ray whose segments are ordered from the observer
outward:

    I(nu) = sum_k S_k(nu) (t_k(nu) - t_{k+1}(nu)) + I_bg(nu) t_end(nu),
    t_k = exp(-sum_{j<k} dtau_j).
"""

from __future__ import annotations

from typing import Optional

import torch


def layer_path_radiance(dtau_layers: torch.Tensor,
                        source_layers: torch.Tensor,
                        seg_layer: torch.Tensor,
                        I_background: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Radiance [..., P] for per-LAYER optics [..., NL, P] traversed in
    ``seg_layer`` order ([n_seg] layer index per segment, observer-first).

    The segment gather and cumulative depth give each segment's emission
    weight t_before - t_after; the weights are summed back onto layers
    (``index_add_``), so each layer's source multiplies the summed weights
    of its crossings.  ``I_background`` [..., P] enters at the far end.
    """
    c = torch.cumsum(dtau_layers.index_select(-2, seg_layer), dim=-2)
    t_after = torch.exp(-c)
    t_before = torch.cat([torch.ones_like(t_after[..., :1, :]),
                          t_after[..., :-1, :]], dim=-2)
    w_layer = torch.zeros_like(dtau_layers).index_add_(
        dtau_layers.dim() - 2, seg_layer, t_before - t_after)
    emitted = torch.sum(source_layers * w_layer, dim=-2)
    if I_background is not None:
        emitted = emitted + I_background * t_after[..., -1, :]
    return emitted
