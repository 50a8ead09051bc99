"""The sharded retrieval of the port (spectrobot_tpu_torch/parallel/oe.py and
retrieval.py) in gloo ranks, in float64: the forward, the normal equations
(F, H, g) and the all-gathered Jacobian of make_sharded_oe against the
JAX package's single-device Jacobian and the port's, on limb (with and
without the ILS, psum and nu-halo tiers) and nadir scenes; then the CLI
(``cli.main``) forward and retrieve under 2 ranks with compute.mesh_nu = 2
against the single-device CLI, line by line and through the (P, T)
table."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band, co_fundamental
from spectrobot_tpu.ops.ils import ils_matrix
from spectrobot_tpu.ops.strengths import device_lines_from_linelist
from spectrobot_tpu.retrieval.state import build_forward as j_build_forward
from spectrobot_tpu.retrieval.state import flatten_state as j_flatten
from spectrobot_tpu.retrieval.state import make_state as j_make_state
from spectrobot_tpu_torch import cli, interop
from spectrobot_tpu_torch.data.atmosphere import MARS
from spectrobot_tpu_torch.parallel.mesh import _free_port
from spectrobot_tpu_torch.retrieval.state import (
    build_forward, flatten_state, make_state)

import torch_mesh_cases as cases
from test_torch_cli import TINY_TOML

torch.set_num_threads(1)

CPU = torch.device("cpu")
SPECIES = ["CO2", "CO"]
SEC, T_SURF = [1.0, 1.15, 1.3, 1.5], 235.0
# name -> (mesh shape by world size, scene variant, make_sharded_oe kwargs)
CASES = {
    "ils": ({2: (1, 1, 2), 4: (2, 1, 2)}, "limb", {}),
    "no-ils": ({2: (1, 1, 2), 4: (2, 1, 2)}, "limb-noils", {}),
    "halo": ({2: (1, 1, 2), 4: (1, 2, 2)}, "limb-cut5",
             {"nu_halo": True, "cutoff_cm1": 5.0}),
    "nadir": ({2: (1, 2, 1), 4: (2, 2, 1)}, "nadir", {}),
}


@pytest.fixture(scope="module")
def scene():
    atm = mars_standard_atmosphere(n_lev=6, z_top=60e3)
    ll = co2_15um_band(j_max=8)
    co = co_fundamental(j_max=6)
    co.nu0[:] = co.nu0 - 2143.27 + 655.0
    dl = device_lines_from_linelist(ll.concat(co), [(2, 1), (5, 1)],
                                    dtype=jnp.float64)
    nu = np.linspace(645.0, 690.0, 256)
    W = ils_matrix(nu, np.linspace(648.0, 688.0, 24), fwhm=1.0)
    d = {k: np.array(getattr(atm, k)) for k in ("z", "p", "T", "n")}
    d["vmr"] = {k: np.array(v) for k, v in atm.vmr.items()}
    return {"jax": (atm, dl), "atm": d, "species": SPECIES, "nu": nu,
            "W": W, "h_t": np.array([6e3, 14e3, 22e3, 30e3]),
            "lines": {k: np.array(v) for k, v in dl._asdict().items()}}


def _variant(scene, name):
    """The scene dict a case gives the ranks, and its forward keywords."""
    sc = {k: v for k, v in scene.items() if k != "jax"}
    kw = {"ils": True, "cutoff": 25.0, "limb": True}
    if name == "limb-noils":
        sc.pop("W")
        kw["ils"] = False
    elif name == "limb-cut5":
        kw["cutoff"] = 5.0
    elif name == "nadir":
        sc.pop("h_t")
        sc.update(sec=np.array(SEC), T_surface=T_SURF)
        kw["limb"] = False
    return sc, kw


def _references(scene, name):
    """(y, K) of the JAX package's and of the port's single-device forward
    at the prior, float64."""
    sc, kw = _variant(scene, name)
    rays = (dict(tangent_heights_m=sc["h_t"]) if kw["limb"]
            else dict(sec_theta=np.array(SEC), T_surface=T_SURF))
    atm, dl = scene["jax"]
    fwd = j_build_forward(atm, dl, jnp.asarray(sc["nu"]), SPECIES, J_MARS,
                          ils_W=jnp.asarray(sc["W"]) if kw["ils"] else None,
                          n_sub=2, cutoff_cm1=kw["cutoff"], chunk=128,
                          **{k: jnp.asarray(v) if k != "T_surface" else v
                             for k, v in rays.items()})
    x0, unravel = j_flatten(j_make_state(atm, ["CO"]))
    f = jax.jit(lambda x: fwd(unravel(x)))
    jref = (np.asarray(f(x0)), np.asarray(jax.jacfwd(f)(x0)))

    t = lambda a: torch.as_tensor(a)
    tatm = interop.atmosphere_from_numpy(sc["atm"], device=CPU)
    tfwd = build_forward(
        tatm, interop.device_lines_from_numpy(sc["lines"], device=CPU),
        t(sc["nu"]), SPECIES, MARS, ils_W=t(sc["W"]) if kw["ils"] else None,
        n_sub=2, cutoff_cm1=kw["cutoff"],
        **{k: t(v) if k != "T_surface" else v for k, v in rays.items()})
    tx0, tunravel = flatten_state(make_state(tatm, ["CO"]))
    g = lambda x: tfwd(tunravel(x))
    tref = (g(tx0).numpy(), torch.func.jacfwd(g)(tx0).numpy())
    return jref, tref


@pytest.fixture(scope="module")
def references(scene):
    return {name: _references(scene, variant)
            for name, (_, variant, _) in CASES.items()}


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, scene, references, tmp_path_factory):
    world, refs = request.param, references
    todo = []
    for name, (shapes, variant, kw) in CASES.items():
        y = refs[name][0][0] * 1.01 + 1e-9
        sigma = np.full(y.shape, 0.002 * y.max())
        todo.append((name, shapes[world], kw, _variant(scene, variant)[0],
                     y, sigma))
    got = cases.run(tmp_path_factory.mktemp(f"oe{world}"), world,
                    cases.mesh_retrieval_case, todo)
    return world, refs, {t[0]: (t[4], t[5]) for t in todo}, got


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_oe_matches(ranks, name):
    world, refs, obs, got = ranks
    y, sigma = obs[name]
    w = 1.0 / sigma ** 2
    for (y_ref, K_ref) in refs[name]:
        KtW = K_ref.T * w[None, :]
        for r in range(world):
            fwd, (F, H, g), K, row_axes = got[r][name]
            np.testing.assert_allclose(fwd.numpy(), y_ref, rtol=1e-12,
                                       atol=np.abs(y_ref).max() * 1e-14)
            np.testing.assert_allclose(F.numpy(), y_ref, rtol=1e-12,
                                       atol=np.abs(y_ref).max() * 1e-14)
            np.testing.assert_allclose(H.numpy(), KtW @ K_ref, rtol=1e-9)
            np.testing.assert_allclose(g.numpy(), KtW @ (y - y_ref),
                                       rtol=1e-9)
            np.testing.assert_allclose(K.numpy(), K_ref, rtol=1e-9,
                                       atol=1e-16)
            # The ILS mixes nu away: its rows are sharded over ray alone.
            ils = name != "no-ils"
            assert row_axes == (("ray",) if ils else ("ray", "nu"))


# ---------------------------------------------------------------------------
# the CLI under 2 ranks
# ---------------------------------------------------------------------------

CLI_OVERRIDES = ["-o", "compute.dtype=float64", "-o", "compute.cutoff_cm1=5",
                 "-o", "retrieval.max_iter=4"]


@pytest.fixture(scope="module")
def tiny_toml(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.toml"
    path.write_text(TINY_TOML)
    return str(path)


def _run_single(toml, out):
    for cmd in ("forward", "retrieve"):
        assert cli.main([cmd, toml, "--device", "cpu", "-o",
                         f"run.output_dir={out}", *CLI_OVERRIDES]) == 0


def test_cli_mesh_matches_single_device(tiny_toml, tmp_path):
    """forward (nu-halo tier) and retrieve (psum tier) with
    compute.mesh_nu = 2 under 2 gloo ranks started with torchrun's
    environment: rank 0's outputs equal the single-device CLI's."""
    _run_single(tiny_toml, tmp_path / "single")
    out = tmp_path / "mesh"
    runs = [(["forward", "-o", f"run.output_dir={out}", "-o",
              "compute.mesh_nu=2", "-o", "compute.mesh_halo=true",
              *CLI_OVERRIDES], _free_port()),
            (["retrieve", "-o", f"run.output_dir={out}", "-o",
              "compute.mesh_nu=2", *CLI_OVERRIDES], _free_port())]
    cases.run(tmp_path / "ranks", 2, cases.cli_case, tiny_toml, runs,
              join_group=False)
    ref = np.load(tmp_path / "single" / "forward.npz")
    got = np.load(out / "forward.npz")
    np.testing.assert_allclose(got["values"], ref["values"], rtol=1e-10,
                               atol=np.abs(ref["values"]).max() * 1e-12)
    ref = np.load(tmp_path / "single" / "retrieval.npz")
    got = np.load(out / "retrieval.npz")
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-8)
    np.testing.assert_allclose(got["chi2"], ref["chi2"], rtol=1e-8)
    assert int(got["n_iter"]) == int(ref["n_iter"])
    assert bool(got["converged"]) == bool(ref["converged"])
    with open(out / "run.jsonl") as f:         # rank 0 alone logs
        iters = [json.loads(line) for line in f if '"chi2"' in line]
    assert len(iters) == int(ref["n_iter"])


def test_cli_mesh_without_its_ranks_raises(tiny_toml, tmp_path,
                                           monkeypatch):
    """A mesh of 2 ranks in a world of 1 (no torchrun) never runs quietly on
    one device; nor does a world of 2 ranks with no mesh configured."""
    argv = ["forward", tiny_toml, "--device", "cpu", "-o",
            f"run.output_dir={tmp_path}"]
    with pytest.raises(ValueError, match="a mesh of 2 ranks, but the run has 1"):
        cli.main(argv + ["-o", "compute.mesh_nu=2"])
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="sets no mesh"):
        cli.main(argv)


LUT_OVERRIDES = ["-o", "compute.use_lut=true", "-o", "compute.lut_n_T=5",
                 "-o", "compute.lut_n_p=6"]


def test_cli_mesh_lut_matches_single_device(tiny_toml, tmp_path):
    """compute.use_lut on the mesh: forward and retrieve under 2 gloo ranks
    with compute.mesh_nu = 2 (the tables cut over nu) and the lattice
    build shared over the ranks (compute.lut_build_mesh), against the
    single-device table CLI."""
    single = tmp_path / "single"
    for cmd in ("forward", "retrieve"):
        assert cli.main([cmd, tiny_toml, "--device", "cpu", "-o",
                         f"run.output_dir={single}", *CLI_OVERRIDES,
                         *LUT_OVERRIDES]) == 0
    out = tmp_path / "mesh"
    mesh = ["-o", f"run.output_dir={out}", "-o", "compute.mesh_nu=2", "-o",
            "compute.lut_build_mesh=true", *CLI_OVERRIDES, *LUT_OVERRIDES]
    cases.run(tmp_path / "ranks", 2, cases.cli_case, tiny_toml,
              [(["forward", *mesh], _free_port()),
               (["retrieve", *mesh], _free_port())], join_group=False)
    ref = np.load(single / "forward.npz")
    got = np.load(out / "forward.npz")
    np.testing.assert_allclose(got["values"], ref["values"], rtol=1e-10,
                               atol=np.abs(ref["values"]).max() * 1e-12)
    ref = np.load(single / "retrieval.npz")
    got = np.load(out / "retrieval.npz")
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-8)
    np.testing.assert_allclose(got["chi2"], ref["chi2"], rtol=1e-8)
    assert int(got["n_iter"]) == int(ref["n_iter"])
    assert bool(got["converged"]) and bool(ref["converged"])
