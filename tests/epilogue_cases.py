"""Inputs and an oracle for the fused RT epilogue
(spectrobot_tpu_torch/ops/cuda_epilogue.py, csrc/rt_epilogue.cu), shared by
tests/test_torch_epilogue.py, tests/test_torch_epilogue_cuda.py and
chip_smoke.py phase 4d:

- ``CELLS``: the benchmark cells' ray sets, and :func:`case`, which makes
  one with its Jacobian tangents in K2's unfolded layout;
- :func:`coefficients` and :func:`contract`: the kernel's derivation of the
  tangent (its coefficients a, b, g from one walk over the segments, then
  a contraction with every column) in plain PyTorch, to hold against
  ``torch.func.jvp`` of the composed epilogue.
"""

import torch

from spectrobot_tpu_torch.constants import C1B, C2

# The benchmark cells' ray sets: (rays, layers, points, Jacobian columns,
# non-LTE, grid [cm-1]).
CELLS = {"mars15_lte": (20, 31, 8192, 32, False, (600.0, 750.0)),
         "mars43_nlte_fov": (40, 32, 8192, 33, True, (2280.0, 2400.0))}


def case(dev, dtype, R, NL, P, n_t, nlte, grid, seed=0, limb_path=True):
    """A ray set at a cell's shape: absorption depths 1e-6..10 as K1
    writes them ([B, 2, P], viewed [R, NL, P]), ray r missing its lowest
    layers (depth 0), and their tangents as K2 writes them under
    ``torch.func.jacfwd`` ([B, 2 n_t, P], viewed [n_t, R, NL, P]: not
    contiguous), each 5 % of its depth times a normal draw; the emission
    row equal to the absorption row in LTE, else 0.3..10 times it (a
    non-LTE weight ratio), its tangent the absorption tangent's times the
    ratio plus 5 % of its own depth times a normal draw; a nadir set
    (``limb_path`` False) has a background and its tangent.  Returns
    (primal args, tangent args, K2's buffer) of
    ``ops.cuda_epilogue.radiance`` and ``radiance_tangent``."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda *s: torch.rand(*s, generator=g, dtype=torch.float64)
    randn = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    B = R * NL
    k1 = (10.0 ** (-6.0 + 7.0 * rand(B, 1, P))).repeat(1, 2, 1)
    k2 = (0.05 * k1[:, :1] * randn(B, n_t, P)).unsqueeze(2).repeat(1, 1, 2,
                                                                    1)
    if nlte:
        ratio = 10.0 ** (-0.5 + 1.5 * rand(B, P))
        k1[:, 1] *= ratio
        k2[:, :, 1] = (k2[:, :, 1] * ratio[:, None]
                       + 0.05 * k1[:, 1:] * randn(B, n_t, P))
    k2 = k2.reshape(B, 2 * n_t, P)
    if limb_path:
        for r in range(R):
            k1.view(R, NL, 2, P)[r, :r * NL // (2 * R)] = 0.0
            k2.view(R, NL, 2 * n_t, P)[r, :r * NL // (2 * R)] = 0.0
    k1, k2 = k1.to(dev, dtype), k2.to(dev, dtype)
    dtau = k1.view(R, NL, 2, P)[:, :, 0]
    dtau_em = k1.view(R, NL, 2, P)[:, :, 1] if nlte else None
    d = k2.view(R, NL, n_t, 2, P).permute(2, 0, 1, 3, 4)
    d_tau, d_em = d[:, :, :, 0], (d[:, :, :, 1] if nlte else None)
    nu = torch.linspace(*grid, P, dtype=torch.float64).to(dev, dtype)
    T_air = (140.0 + 110.0 * rand(R, NL)).to(dev, dtype)
    dT = torch.randn(n_t, R, NL, generator=g, dtype=torch.float64)
    up = torch.arange(NL, device=dev)
    seg = torch.cat([up.flip(0), up]) if limb_path else up.flip(0)
    I_bg = d_bg = None
    if not limb_path:
        I_bg = torch.broadcast_to(
            1e-5 * (1.0 + rand(P)).to(dev, dtype), (R, P))
        d_bg = torch.broadcast_to(
            1e-7 * torch.randn(n_t, 1, P, generator=g,
                               dtype=torch.float64).to(dev, dtype),
            (n_t, R, P))
    prim = (nu, T_air, dtau, dtau_em, seg, I_bg)
    return prim, (dT.to(dev, dtype), d_tau, d_em, d_bg), k2


def _tiny(dtype: torch.dtype) -> float:
    return 1e-150 if dtype == torch.float64 else 1e-16


def coefficients(nu, T_air, dtau, dtau_em, seg_layer, I_bg=None):
    """The tangent's coefficients (a, b, g) [R, NL, P] (b None in LTE,
    ``dtau_em`` None) and t_end [R, P], as the kernel forms them: one walk
    over the segments, observer first, summing for each layer over its
    crossings W_l = sum of t_k - t_{k+1} and G_l = sum of S_l t_{k+1} -
    R_k (R_k: what reaches the observer from beyond crossing k); then
    a_l = dB/dT q W_l, b_l = B W_l / dtau_l (0 where dtau_l <= tiny),
    g_l = G_l - q b_l, q the ratio dtau_em / dtau (1 in LTE).  One dtype
    throughout."""
    x = C2 * nu / T_air[..., None]
    e = torch.expm1(x)
    B = C1B * (nu * nu * nu) / e
    slope = B * ((e + 1.0) / e) * (x / T_air[..., None])
    q = None
    if dtau_em is not None:
        ok = dtau > _tiny(dtau.dtype)
        q = torch.where(ok, dtau_em / torch.where(ok, dtau, 1.0), 1.0)
    S = B if q is None else B * q
    c = torch.zeros_like(dtau[:, 0])
    tb, E = torch.ones_like(c), torch.zeros_like(c)
    W, H = torch.zeros_like(dtau), torch.zeros_like(dtau)
    for l in seg_layer.tolist():
        c = c + dtau[:, l]
        ta = torch.exp(-c)
        w = tb - ta
        E = E + S[:, l] * w
        W[:, l] += w
        H[:, l] += S[:, l] * ta + E
        tb = ta
    I = E if I_bg is None else E + I_bg * tb
    n = torch.bincount(seg_layer, minlength=dtau.shape[1]).to(dtau.dtype)
    G = H - n[:, None] * I[:, None, :]
    if q is None:
        return slope * W, None, G, tb
    ok = dtau > _tiny(dtau.dtype)
    b = torch.where(ok, B * (W / torch.where(ok, dtau, 1.0)), 0.0)
    return slope * q * W, b, G - q * b, tb


def contract(coefs, dT, d_tau, d_em, d_bg):
    """The tangent [n_t, R, P] of :func:`coefficients`' (a, b, g, t_end)
    for tangent columns dT [n_t, R, NL], d_tau and d_em [n_t, R, NL, P],
    d_bg [n_t, R, P] (None: zero)."""
    a, b, g, t_end = coefs
    out = torch.einsum("jrlp,rlp->jrp", d_tau, g)
    if dT is not None:
        out = out + torch.einsum("jrl,rlp->jrp", dT, a)
    if b is not None and d_em is not None:
        out = out + torch.einsum("jrlp,rlp->jrp", d_em, b)
    return out if d_bg is None else out + d_bg * t_end
