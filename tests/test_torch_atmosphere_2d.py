"""The latitude x altitude atmosphere of the PyTorch port
(data/atmosphere.py Atmosphere2D, mars_zonal_atmosphere, and the CLI's
slice at scene.latitude_deg) against the JAX package: the five cases of
tests/test_atmosphere_2d.py, each on both packages, in float64."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data import atmosphere as j_atm
from spectrobot_tpu_torch import cli
from spectrobot_tpu_torch.data import atmosphere as t_atm

torch.set_num_threads(1)

CPU = torch.device("cpu")
FIELDS = ("lat_deg", "z", "p", "T", "n")


def _pair(**kw):
    return (j_atm.mars_zonal_atmosphere(**kw),
            t_atm.mars_zonal_atmosphere(**kw, device=CPU))


def _same_1d(got, ref, rtol=1e-12):
    for f in ("z", "p", "T", "n"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=rtol)
    assert sorted(got.vmr) == sorted(ref.vmr)
    for k in ref.vmr:
        np.testing.assert_allclose(got.vmr[k].numpy(), np.asarray(ref.vmr[k]),
                                   rtol=rtol)


def test_node_exact_and_monotone():
    """The climatology equals the reference's; on a grid latitude the slice
    is the stored profile, between two it is bracketed by them, outside
    the grid it is clamped; the equator is warmer than the pole."""
    ref, got = _pair(n_lat=7, n_lev=21, z_top=80e3)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-13)
    for lat in (0.0, 12.5, 30.0, -47.0, 120.0, -95.0):
        _same_1d(got.at_lat(lat), ref.at_lat(lat))
    np.testing.assert_array_equal(got.at_lat(0.0).T.numpy(),
                                  got.T[3].numpy())
    assert float(got.at_lat(0.0).T[0] - got.at_lat(90.0).T[0]) > 20.0
    mid = got.at_lat(0.5 * float(got.lat_deg[3] + got.lat_deg[4])).T
    lo, hi = torch.minimum(got.T[3], got.T[4]), torch.maximum(got.T[3],
                                                             got.T[4])
    assert bool(((mid >= lo - 1e-9) & (mid <= hi + 1e-9)).all())
    np.testing.assert_array_equal(got.at_lat(120.0).T.numpy(),
                                  got.T[-1].numpy())


def test_logp_interpolation():
    """p mixes in log space: half-way between two grid latitudes it is the
    geometric mean of their profiles."""
    ref, got = _pair(n_lat=5, n_lev=11, z_top=60e3)
    lat_q = 0.5 * float(got.lat_deg[1] + got.lat_deg[2])
    _same_1d(got.at_lat(lat_q), ref.at_lat(lat_q))
    np.testing.assert_allclose(got.at_lat(lat_q).p.numpy(),
                               np.sqrt((got.p[1] * got.p[2]).numpy()),
                               rtol=1e-12)


@pytest.mark.parametrize("lat", [25.0, -47.0, -60.0])
def test_differentiable_in_latitude(lat):
    """d/d(lat) of the slice's temperature and pressure sums equals the
    reference's (torch.func.grad against jax.grad) off the grid latitudes.
    On one (-60 deg) the slice takes the cell below it, with w = 1: the
    port's clamp passes the cell's whole slope, the reference's clip half
    of it (JAX's derivative of a clip at its bound)."""
    ref, got = _pair(n_lat=7, n_lev=15, z_top=60e3)
    on_node = bool((got.lat_deg == lat).any())
    for f in ("T", "p"):
        g_ref = jax.grad(lambda x: jnp.sum(getattr(ref.at_lat(x), f)))(lat)
        g = torch.func.grad(lambda x: torch.sum(getattr(got.at_lat(x), f)))(
            torch.tensor(lat, dtype=torch.float64))
        assert abs(float(g_ref)) > 0.0
        np.testing.assert_allclose(float(g), (2.0 if on_node else 1.0)
                                   * float(g_ref), rtol=1e-10)
    if on_node:
        slope = (got.T[1] - got.T[0]) / (got.lat_deg[1] - got.lat_deg[0])
        g = torch.func.grad(lambda x: torch.sum(got.at_lat(x).T))(
            torch.tensor(lat, dtype=torch.float64))
        np.testing.assert_allclose(float(g), float(slope.sum()), rtol=1e-12)


def test_from_profiles_and_round_trip(tmp_path):
    """Stacking 1-D profiles, and the .npz: a file written by either
    package loads in the other with every array equal."""
    a0 = t_atm.mars_standard_atmosphere(n_lev=13, z_top=70e3, device=CPU)
    a1 = a0.with_temperature(a0.T - 15.0)
    got = t_atm.Atmosphere2D.from_profiles([-45.0, 45.0], [a0, a1])
    j0 = j_atm.mars_standard_atmosphere(n_lev=13, z_top=70e3)
    ref = j_atm.Atmosphere2D.from_profiles(
        [-45.0, 45.0], [j0, j0.with_temperature(j0.T - 15.0)])
    tpath, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    got.save_npz(tpath)
    ref.save_npz(jpath)
    for back, want in ((j_atm.Atmosphere2D.load_npz(tpath), got),
                       (t_atm.Atmosphere2D.load_npz(jpath, device=CPU), ref),
                       (t_atm.Atmosphere2D.load_npz(tpath, device=CPU), got)):
        for f in FIELDS:
            np.testing.assert_allclose(np.asarray(getattr(back, f)),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-13)
        assert set(back.vmr) == set(want.vmr)
        np.testing.assert_allclose(np.asarray(back.vmr["CO2"]),
                                   np.asarray(want.vmr["CO2"]), rtol=1e-13)
    with pytest.raises(ValueError, match="altitude grids"):
        t_atm.Atmosphere2D.from_profiles([0.0, 1.0], [a0, t_atm.
            mars_standard_atmosphere(n_lev=13, z_top=60e3, device=CPU)])


TOML = """
[grid]
nu_min = 660.0
nu_max = 674.0
n_points = 200
[scene]
atmosphere = "{atm}"
latitude_deg = {lat}
n_levels = 9
z_top_m = 60e3
[geometry]
tangent_heights_km = [15.0]
n_sub = 2
[compute]
dtype = "float64"
chunk = 128
[run]
output_dir = "{out}"
"""


def test_cli_2d_latitude_selection(tmp_path, capsys):
    """Both CLIs at the equator and near the pole, from "mars_zonal" and
    from a 2-D .npz: the port's forward.npz equals the reference's within
    1e-10 of max, and the colder, thinner polar atmosphere dims the 15 um
    limb."""
    from spectrobot_tpu.cli import main as jax_main

    npz = str(tmp_path / "zonal.npz")
    t_atm.mars_zonal_atmosphere(n_lev=9, z_top=60e3, device=CPU).save_npz(npz)
    peaks = {}
    for atm in ("mars_zonal", npz):
        for lat in (0.0, 85.0):
            out = {}
            for who in ("jax", "port"):
                d = tmp_path / f"{who}{lat}{len(atm)}"
                path = tmp_path / f"{who}.toml"
                path.write_text(TOML.format(atm=atm, lat=lat, out=d))
                assert (jax_main(["forward", str(path)]) if who == "jax" else
                        cli.main(["forward", str(path), "--device", "cpu"])
                        ) == 0
                with np.load(os.path.join(d, "forward.npz")) as z:
                    out[who] = z["radiance"]
            np.testing.assert_allclose(out["port"], out["jax"], rtol=0,
                                       atol=1e-10 * out["jax"].max())
            peaks[atm, lat] = out["port"].max()
        assert peaks[atm, 85.0] < 0.95 * peaks[atm, 0.0]
    capsys.readouterr()
    scene = cli.build_scene(cli.load_config(None, {
        "scene.atmosphere": "mars_zonal", "scene.latitude_deg": "85.0",
        "scene.n_levels": "9", "scene.z_top_m": "60e3"}), CPU)
    _same_1d(scene.atm, j_atm.mars_zonal_atmosphere(n_lev=9, z_top=60e3)
             .at_lat(85.0))
