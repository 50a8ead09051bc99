"""Line-of-sight radiative-transfer integrator (port of
``spectrobot_tpu.forward.rt``).

Emission-only RT along a ray whose segments are ordered from the observer
outward:

    I(nu) = sum_k S_k(nu) (t_k(nu) - t_{k+1}(nu)) + I_bg(nu) t_end(nu),
    t_k = exp(-sum_{j<k} dtau_j).
"""

from __future__ import annotations

from typing import Optional

import torch


def radiance_along_ray(dtau: torch.Tensor, source: torch.Tensor,
                       I_background: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Radiance [..., P] at the observer of one or many rays: per-segment
    optical depth ``dtau`` and source radiance ``source`` [..., n_seg, P]
    in observer-first order, ``I_background`` [..., P] entering the far end
    (default 0: deep space).

    The cumulative depth is ``torch.cumsum`` over the segment axis: the
    same function as the reference's, which takes a lower-triangular
    matrix product instead on the TPU only (its cumsum lowered to a
    sequential loop there)."""
    t_after = torch.exp(-torch.cumsum(dtau, dim=-2))
    # The transmittance before segment k is t_after of segment k-1 (1 at
    # the observer): a shift, not a second exp.
    t_before = torch.cat([torch.ones_like(t_after[..., :1, :]),
                          t_after[..., :-1, :]], dim=-2)
    emitted = torch.sum(source * (t_before - t_after), dim=-2)
    if I_background is not None:
        emitted = emitted + I_background * t_after[..., -1, :]
    return emitted


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


def transmittance(dtau: torch.Tensor) -> torch.Tensor:
    """Total transmittance along the ray [..., P] of per-segment depths
    [..., n_seg, P]."""
    return torch.exp(-torch.sum(dtau, dim=-2))
