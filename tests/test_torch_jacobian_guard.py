"""The Jacobian's memory guard (spectrobot_tpu_torch/cli.py:make_jacobian):
the reference's rule (``retrieval.jac_chunk`` chunks at that size; auto
mode chunks at 16 columns past a limit) on the port's own bytes, counted by
``jacobian_bytes`` in the compute dtype, against half of the card's memory
on a CUDA device and the reference's 8 GB on the CPU."""

import os
import types

import numpy as np
import pytest
import torch

from spectrobot_tpu_torch import cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE = os.path.join(REPO, "examples", "mars_limb.toml")
CHUNKED = "jacobian: chunked forward-mode (16 tangent columns)"
# An H100 80GB HBM3's total memory as torch reports it.
H100_BYTES = 85_045_379_072


@pytest.fixture
def h100(monkeypatch):
    """A CUDA device of an H100's memory, for the guard's limit."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            total_memory=H100_BYTES))
    return torch.device("cuda", 0)


def _toy():
    """A flat forward of 5 parameters and its Jacobian by jacfwd."""
    A = torch.as_tensor(np.random.default_rng(2).normal(size=(7, 5)))
    f = lambda x: torch.sin(A @ x) * x.sum()
    x = torch.linspace(0.1, 0.5, 5, dtype=torch.float64)
    return f, x, torch.func.jacfwd(f)(x)


def _n_x(cfg):
    return cfg.scene.n_levels     # a temperature retrieval: one a level


def test_guard_chunks_a_scene_past_the_limit(capsys, h100):
    """Counted bytes past the limit chunk at 16 columns, on the CPU (8 GB)
    and on the card (half its memory), with the same values."""
    f, x, J = _toy()
    cfg = cli.load_config(SLICE, {"grid.n_points": "65536"})
    counted = cli.jacobian_bytes(cfg, _n_x(cfg), cfg.grid.n_points)
    assert counted > cli.jacobian_limit(h100) > cli.JAC_HOST_LIMIT
    for dev in ("cpu", h100):
        assert cli.jacobian_chunk(cfg, _n_x(cfg), cfg.grid.n_points,
                                  dev) == 16
        jac = cli.make_jacobian(cfg, f, _n_x(cfg), cfg.grid.n_points, dev)
        assert CHUNKED in capsys.readouterr().err
        torch.testing.assert_close(jac(x), J, rtol=1e-12, atol=0.0)


def test_guard_leaves_the_slice_unchunked_on_the_card(capsys, h100):
    """examples/mars_limb.toml (33 columns, 20 rays, 32 layers, 8192
    points) stays one jacfwd on the card."""
    f, x, J = _toy()
    cfg = cli.load_config(SLICE)
    n_fine = cfg.grid.n_points
    assert cli.jacobian_limit(h100) == H100_BYTES / 2
    assert cli.jacobian_bytes(cfg, _n_x(cfg), n_fine) < H100_BYTES / 2
    assert cli.jacobian_chunk(cfg, _n_x(cfg), n_fine, h100) is None
    jac = cli.make_jacobian(cfg, f, _n_x(cfg), n_fine, h100)
    assert "chunked" not in capsys.readouterr().err
    torch.testing.assert_close(jac(x), J, rtol=0.0, atol=0.0)


def test_guard_counts_float64_twice_float32():
    f32 = cli.load_config(SLICE)
    f64 = cli.load_config(SLICE, {"compute.dtype": "float64",
                                  "compute.variant": "weideman"})
    n = (_n_x(f32), f32.grid.n_points)
    assert cli.jacobian_bytes(f64, *n) == 2 * cli.jacobian_bytes(f32, *n)
    assert cli.jacobian_bytes(f32, *n) == (
        cli.JAC_LIVE_TANGENTS * 4 * 33 * 20 * 32 * 8192)


def test_guard_counts_the_rays_under_a_fov():
    """Under a field of view the forward runs the fine ladder's rays."""
    cfg = cli.load_config(SLICE)
    fov = cli.load_config(SLICE, {"instrument.fov_fwhm_km": "3.0",
                                  "instrument.fov_n_fine": "40"})
    n = (_n_x(cfg), cfg.grid.n_points)
    assert cli.jacobian_bytes(fov, *n) == 2 * cli.jacobian_bytes(cfg, *n)


def test_jac_chunk_overrides_the_count(capsys, h100):
    """retrieval.jac_chunk chunks at its size whatever the count, on
    either device, with the same values."""
    f, x, J = _toy()
    cfg = cli.load_config(SLICE, {"retrieval.jac_chunk": "2",
                                  "grid.n_points": "256"})
    assert cli.jacobian_bytes(cfg, 5, 256) < cli.JAC_HOST_LIMIT
    for dev in ("cpu", h100):
        assert cli.jacobian_chunk(cfg, 5, 256, dev) == 2
        jac = cli.make_jacobian(cfg, f, 5, 256, dev)
        assert ("jacobian: chunked forward-mode (2 tangent columns)"
                in capsys.readouterr().err)
        torch.testing.assert_close(jac(x), J, rtol=1e-12, atol=0.0)
