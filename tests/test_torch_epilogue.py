"""The fused RT epilogue (spectrobot_tpu_torch/ops/cuda_epilogue.py) on the
CPU, where its Functions run the plain version (the composed ops), against
the composed PyTorch epilogue (forward/limb.py ``optics_from_tau`` +
forward/rt.py ``layer_path_radiance``) in float64:

- the kernel's derivation of the tangent (tests/epilogue_cases.py: the
  coefficients of one segment walk, contracted with every column) against
  ``torch.func.jacfwd`` of the composed epilogue, to ~1e-12 of the largest
  value, on a limb in LTE (no emission depth), a limb in non-LTE and nadir
  paths over a black surface whose background has a tangent;
- the primal, and ``torch.func.jacfwd`` through ``RadianceEpilogue``'s jvp
  and ``EpilogueTangent``'s vmap rule (every column in one call), one
  ``torch.func.jvp``, a chunked Jacobian (16 columns a vmap) and a
  structural vmap over atmospheres (the fallback: one call an element);
- the types (the sources in T_air's dtype over float32 depths) and a ray
  set too large for a block, which raises;
- the route (``forward.limb.fused_epilogue``): the plain engine, the CPU,
  reverse mode, plain autograd and a grey surface take the composed ops;
  ``EPILOGUE_COUNTS`` counts each call once, and a CLI retrieval problem
  with the card's route forced gives the composed route's Jacobian;
- the benchmark's ``epilogue_fused_pct`` reads None without counts.

The kernel itself runs on the card (tests/test_torch_epilogue_cuda.py)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spectrobot_tpu_torch import cli
from spectrobot_tpu_torch.forward import limb
from spectrobot_tpu_torch.forward.rt import layer_path_radiance
from spectrobot_tpu_torch.ops import cuda_epilogue as ce
from spectrobot_tpu_torch.ops.cuda_basis import KERNELS, PLAIN
from spectrobot_tpu_torch.ops.planck import planck_nu

import epilogue_cases

torch.set_num_threads(1)

F64 = torch.float64
CPU = torch.device("cpu")
# The small retrieval scene of tests/test_torch_jacobian_graph.py, float64.
SLICE = {"grid.nu_min": "660.0", "grid.nu_max": "674.0",
         "grid.n_points": "256", "scene.n_levels": "7",
         "scene.z_top_m": "60e3", "geometry.tangent_heights_km": "8.0,25.0",
         "geometry.n_sub": "2", "instrument.enabled": "true",
         "instrument.fwhm_cm1": "0.4", "instrument.n_channels": "16",
         "compute.dtype": "float64"}


def _scene(kind: str, n_x: int = 7, R: int = 3, NL: int = 6, P: int = 40,
           seed: int = 0):
    """(nu, seg_layer, x, inputs(x)) of a random ray set: ``kind`` "lte"
    or "nlte" (a limb; ray r misses its r lowest layers, whose depths are
    0; a few depths below the float64 threshold), "nadir" or "nadir_nlte"
    (a black surface behind, its radiance a function of x).  inputs(x) ->
    (T_air, dtau, dtau_em or None, I_bg or None), smooth in x."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=F64)
    nu = torch.linspace(600.0, 750.0, P, dtype=F64)
    T0 = t(rng.uniform(140.0, 250.0, (R, NL)))
    tau0 = 10.0 ** rng.uniform(-4.0, 0.5, (R, NL, P))
    limb_path = kind in ("lte", "nlte")
    if limb_path:
        for r in range(R):
            tau0[r, :r] = 0.0
    tau0[0, -1, :3] = 1e-200
    em0 = tau0 * rng.uniform(0.5, 2.0, tau0.shape)
    tau0, em0 = t(tau0), t(em0)
    MT = t(rng.normal(0.0, 3.0, (R, NL, n_x)))
    Mtau = t(rng.normal(0.0, 0.2, (R, NL, P, n_x)))
    Mem = t(rng.normal(0.0, 0.2, (R, NL, P, n_x)))
    mbg = t(rng.normal(0.0, 3.0, n_x))
    up = torch.arange(NL)
    seg = torch.cat([up.flip(0), up]) if limb_path else up.flip(0)
    nlte = kind in ("nlte", "nadir_nlte")

    def inputs(x):
        T_air = T0 + MT @ x
        dtau = tau0 * torch.exp(Mtau @ x)
        dtau_em = em0 * torch.exp(Mem @ x) if nlte else None
        I_bg = None
        if not limb_path:
            I_bg = torch.broadcast_to(planck_nu(nu, 210.0 + mbg @ x), (R, P))
        return T_air, dtau, dtau_em, I_bg

    x = t(rng.normal(0.0, 1.0, n_x))
    return nu, seg, x, inputs


def _composed(nu, seg, inputs):
    def f(x):
        T_air, dtau, dtau_em, I_bg = inputs(x)
        optics = limb.optics_from_tau(nu, SimpleNamespace(T_air=T_air), dtau,
                                      dtau if dtau_em is None else dtau_em)
        return layer_path_radiance(optics.dtau, optics.source, seg, I_bg)
    return f


def _fused(nu, seg, inputs):
    def f(x):
        T_air, dtau, dtau_em, I_bg = inputs(x)
        return ce.RadianceEpilogue.apply(nu, T_air, dtau, dtau_em, seg, I_bg)
    return f


def _close(got, ref, rel=1e-12):
    err = float((got - ref).abs().max())
    assert err <= rel * float(ref.abs().max()), (err, float(ref.abs().max()))


KINDS = ["lte", "nlte", "nadir", "nadir_nlte"]


@pytest.mark.parametrize("kind", KINDS)
def test_primal_matches_the_composed_epilogue(kind):
    nu, seg, x, inputs = _scene(kind)
    ref = _composed(nu, seg, inputs)(x)
    got = _fused(nu, seg, inputs)(x)
    assert got.shape == ref.shape and got.dtype == F64
    _close(got, ref, 1e-13)


def _count_tangent_calls(monkeypatch) -> list:
    """The shapes of dtau in each ``radiance_tangent`` call from here on."""
    calls = []
    tangent = ce.radiance_tangent

    def counted(*a):
        calls.append((tuple(a[2].shape), a[7].shape[0]))
        return tangent(*a)

    monkeypatch.setattr(ce, "radiance_tangent", counted)
    return calls


@pytest.mark.parametrize("kind", KINDS)
def test_jacfwd_matches_the_composed_epilogue(monkeypatch, kind):
    """Every column through one EpilogueTangent call (the vmap rule folds
    the tangent batch)."""
    nu, seg, x, inputs = _scene(kind)
    calls = _count_tangent_calls(monkeypatch)
    got = torch.func.jacfwd(_fused(nu, seg, inputs))(x)
    monkeypatch.undo()
    ref = torch.func.jacfwd(_composed(nu, seg, inputs))(x)
    assert [n for _, n in calls] == [x.shape[0]]
    _close(got, ref)


def test_a_single_jvp_matches_the_composed_epilogue():
    nu, seg, x, inputs = _scene("nlte", seed=1)
    v = torch.linspace(-1.0, 1.0, x.shape[0], dtype=F64)
    y, dy = torch.func.jvp(_fused(nu, seg, inputs), (x,), (v,))
    y_ref, dy_ref = torch.func.jvp(_composed(nu, seg, inputs), (x,), (v,))
    _close(y, y_ref, 1e-13)
    _close(dy, dy_ref)


def test_the_chunked_jacobian_matches_the_composed_epilogue():
    """``retrieval.state.jacobian_fwd_chunked``'s form: a vmap of
    ``torch.func.jvp`` over 16 columns of the identity at a time."""
    from spectrobot_tpu_torch.retrieval.state import jacobian_fwd_chunked

    nu, seg, x, inputs = _scene("nlte", n_x=20, seed=2)
    flat = lambda f: (lambda v: f(v).reshape(-1))
    got = jacobian_fwd_chunked(flat(_fused(nu, seg, inputs)), x, chunk=16)
    ref = torch.func.jacfwd(flat(_composed(nu, seg, inputs)))(x)
    _close(got, ref)


def test_a_structural_vmap_takes_one_call_an_element(monkeypatch):
    """Atmospheres under ``torch.func.vmap`` (the primal batched) of a
    Jacobian: the Functions fall back to one call an element (each with
    every column), with the composed epilogue's values."""
    nu, seg, x, inputs = _scene("nlte", seed=3)
    xs = torch.stack([x, 0.5 * x, -x])
    calls = _count_tangent_calls(monkeypatch)
    got = torch.func.vmap(torch.func.jacfwd(_fused(nu, seg, inputs)))(xs)
    monkeypatch.undo()
    ref = torch.func.vmap(torch.func.jacfwd(_composed(nu, seg, inputs)))(xs)
    assert calls == [((3, 6, 40), x.shape[0])] * 3
    _close(got, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_the_kernels_derivation_is_the_composed_tangent(kind):
    """The coefficients of one segment walk, contracted with the columns
    of the identity, give ``torch.func.jacfwd`` of the composed
    epilogue."""
    nu, seg, x, inputs = _scene(kind, seed=6)
    ref = torch.func.jacfwd(_composed(nu, seg, inputs))(x)   # [R, P, n_x]
    prim = inputs(x)
    given = [k for k, t in enumerate(prim) if t is not None]
    cols = torch.func.vmap(lambda v: torch.func.jvp(
        lambda y: tuple(inputs(y)[k] for k in given), (x,), (v,))[1])(
        torch.eye(x.shape[0], dtype=F64))
    tangents = [None] * 4
    for k, t in zip(given, cols):
        tangents[k] = t
    coefs = epilogue_cases.coefficients(nu, *prim[:3], seg, prim[3])
    got = epilogue_cases.contract(coefs, *tangents)
    _close(got.movedim(0, -1), ref)


def test_lte_reads_no_emission_depth():
    """In LTE the ratio is 1 and its tangent 0: the coefficients have no
    emission term, and those of the emission depth equal to the absorption
    depth give the same tangent (b + g there is the LTE g)."""
    nu, seg, x, inputs = _scene("lte", seed=4)
    T_air, dtau, _, _ = inputs(x)
    a, b, g, t_end = epilogue_cases.coefficients(nu, T_air, dtau, None, seg)
    a2, b2, g2, t_end2 = epilogue_cases.coefficients(nu, T_air, dtau, dtau,
                                                     seg)
    assert b is None and a.shape == g.shape == dtau.shape
    assert t_end.shape == (dtau.shape[0], dtau.shape[2])
    _close(a2, a)
    _close(b2 + g2, g)
    assert torch.equal(t_end2, t_end)


def test_the_sources_take_the_atmospheres_dtype():
    """Float32 depths under a float64 atmosphere (the CLI forward's): the
    radiance and its tangent in float64, as the composed ops promote."""
    nu, seg, x, inputs = _scene("nlte", seed=7)
    T_air, dtau, dtau_em, _ = inputs(x)
    f32 = torch.float32
    args = (nu.to(f32), T_air, dtau.to(f32), dtau_em.to(f32), seg, None)
    assert ce.source_dtype(args[2], T_air) == F64
    I = ce.RadianceEpilogue.apply(*args)
    assert I.dtype == F64
    _close(I, _composed(nu.to(f32), seg, lambda _: (
        T_air, dtau.to(f32), dtau_em.to(f32), None))(x), 0.0)
    dT = torch.ones((2,) + T_air.shape, dtype=F64)
    dI = ce.radiance_tangent(*args, dT, None, None, None)
    assert dI.dtype == F64 and dI.shape == (2,) + I.shape


def test_a_ray_set_too_large_for_a_block_raises():
    """The kernel's block holds every layer of its rays: a ray set beyond
    its shared memory raises, naming the way out, before any launch."""
    NL = 120
    assert ce.takes(NL, 2 * NL, torch.float32)
    assert not ce.takes(NL, 2 * NL, torch.float64)
    R, P = 2, 8
    dtau = torch.ones(R, NL, P, dtype=F64)
    up = torch.arange(NL)
    with pytest.raises(ValueError, match="compute.use_pallas"):
        ce._launch(torch.empty(R, P, dtype=F64), torch.ones(P, dtype=F64),
                   torch.ones(R, NL, dtype=F64), dtau, None,
                   torch.cat([up.flip(0), up]), None)


@pytest.mark.parametrize("engine,mode,card,is_limb,eps,fused", [
    ("kernels", True, True, True, 1.0, True),
    ("kernels", "fwd", True, False, 1.0, True),
    ("plain", True, True, True, 1.0, False),
    ("kernels", True, False, True, 1.0, False),
    ("kernels", "rev", True, True, 1.0, False),
    ("kernels", False, True, True, 1.0, False),
    ("kernels", True, True, False, 0.9, False),
    (None, True, True, True, 1.0, False),
])
def test_the_route(monkeypatch, engine, mode, card, is_limb, eps, fused):
    """The fused kernel only for the kernels' engine, on the card, in
    analytic forward mode, on a limb or a black surface; ``engine`` None
    (the table runtime, the mesh bodies) takes the composed ops."""
    monkeypatch.setattr(limb, "_on_card", lambda t: card)
    nu, seg, x, inputs = _scene("lte" if is_limb else "nadir")
    T_air, dtau, _, I_bg = inputs(x)
    cg = SimpleNamespace(T_air=T_air, seg_layer=seg)
    eng = {"kernels": KERNELS, "plain": PLAIN, None: None}[engine]
    assert limb.fused_epilogue(eng, mode, dtau, is_limb, eps) is fused
    before = dict(limb.EPILOGUE_COUNTS)
    I = limb.tau_radiance_epilogue(nu, cg, dtau, dtau, None, I_bg, is_limb,
                                   eps, engine=eng, analytic_jvp=mode,
                                   lte=True)
    route = "fused" if fused else "composed"
    other = "composed" if fused else "fused"
    assert limb.EPILOGUE_COUNTS[route] == before[route] + 1
    assert limb.EPILOGUE_COUNTS[other] == before[other]
    assert I.shape == (dtau.shape[0], dtau.shape[2])


@pytest.mark.parametrize("overrides", [
    {}, {"lines.source": "synthetic:co2_43um", "grid.nu_min": "2280.0",
         "grid.nu_max": "2400.0", "nlte.enabled": "true",
         "nlte.t_vib": "demo:co2_pump"},
    {"geometry.mode": "nadir", "geometry.sec_theta": "1.0,1.5"}],
    ids=["lte", "nlte", "nadir"])
def test_the_retrieval_jacobian_is_the_composed_one(monkeypatch, overrides):
    """The CLI's retrieval problem (float64, the kernels' engine on the
    CPU: the line sums' plain versions; a limb in LTE and in non-LTE, a
    nadir over a black surface) with the card's route forced: the
    forward and its ``torch.func.jacfwd`` take the fused Functions (each
    call counted once as fused: one eager forward, one Jacobian) and give
    the composed route's values."""
    cfg = cli.load_config(None, {**SLICE, **overrides})
    scene = cli.build_scene(cfg, CPU)
    prob = cli.retrieval_problem(cfg, scene, cli.select_engine(cfg, CPU))
    y_ref = prob.fwd_flat(prob.x0)
    J_ref = torch.func.jacfwd(prob.fwd_flat)(prob.x0)
    monkeypatch.setattr(limb, "_on_card", lambda t: True)
    before = dict(limb.EPILOGUE_COUNTS)
    y = prob.fwd_flat(prob.x0)
    J = torch.func.jacfwd(prob.fwd_flat)(prob.x0)
    assert limb.EPILOGUE_COUNTS["fused"] == before["fused"] + 2
    assert limb.EPILOGUE_COUNTS["composed"] == before["composed"]
    _close(y, y_ref, 1e-13)
    _close(J, J_ref)


def test_epilogue_fused_pct_reads_the_counts(monkeypatch):
    """The benchmark's reader: None without units, without the program's
    counts (the parent's program) or before any call; else the fused
    share."""
    from spectrobench import manifest

    read = manifest.reader("epilogue_fused_pct")
    rec = {"units": [{}]}
    assert read({}) is None
    monkeypatch.delattr(limb, "EPILOGUE_COUNTS")
    assert read(rec) is None
    monkeypatch.setattr(limb, "EPILOGUE_COUNTS",
                        {"fused": 0, "composed": 0}, raising=False)
    assert read(rec) is None
    monkeypatch.setattr(limb, "EPILOGUE_COUNTS", {"fused": 3, "composed": 1},
                        raising=False)
    assert read(rec) == 75.0
