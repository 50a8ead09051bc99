"""Shared settings of the benchmark's CPU tests: small scenes of the
cells' configurations (the kernels' plain versions run on the CPU), and
the card check left to the tests marked ``cuda``."""

import pytest
import torch

# A cell's configuration cut to a size a CPU test holds: 512 lines, 256
# points over the cell's band, 8 levels, 4 rays, 32 channels.
SMALL = {"bench.lines.n_lines": "512", "grid.n_points": "256",
         "scene.n_levels": "8",
         "geometry.tangent_heights_km": "10,20,30,40",
         "instrument.n_channels": "32"}
# The four-card cell's grid at the same points a rank.
SMALL_FINE4 = {**SMALL, "grid.n_points": "512"}


@pytest.fixture(autouse=True)
def _own_cache(tmp_path, monkeypatch):
    """Each test's benchmark cache in its own temporary directory."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda")
