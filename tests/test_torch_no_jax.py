"""The port runs where JAX and the JAX package are not installed: every
module of spectrobot_tpu_torch (the mesh's parallel/, K3's
ops/cuda_single.py, K4's ops/cuda_basis_single.py and the remote-copy
tier's dma_halo.py, parallel/cuda_dma.py and parallel/peer.py, the table
tier's ops/lut.py and parallel/sharded_lut.py, and the Weideman
evaluator's ops/voigt.py, the Spectrum family's spectra.py, forward/rt.py,
ops/planck.py and utils/profiling.py and utils/debug.py, and the
exchange's trace tool halo_overlap.py among them),
chip_smoke.py and ablate_basis.py import, and the tiny forward and retrieval (``python -m
spectrobot_tpu_torch``, and a Weideman forward with run.save_optics), a config-1 Jacobian and the adjoint tool
(``python -m spectrobot_tpu_torch.adjoint``) run on CPU, in a fresh
interpreter that holds no jax and no module of spectrobot_tpu."""

import os
import subprocess
import sys

import pytest

from test_torch_cli import TINY_TOML

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, runpy, sys
if {block}:
    sys.modules["jax"] = None        # any import of jax now raises
    sys.modules["spectrobot_tpu"] = None     # ... and of the JAX package
import spectrobot_tpu_torch
for m in pkgutil.walk_packages(spectrobot_tpu_torch.__path__,
                               "spectrobot_tpu_torch."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
for name in ("parallel.mesh", "parallel.collectives", "parallel.halo",
             "parallel.sharded", "parallel.retrieval", "parallel.oe",
             "ops.cuda_single", "ops.cuda_basis_single", "ops.chi",
             "forward.model", "dma_halo", "parallel.cuda_dma", "parallel.peer",
             "ops.lut", "parallel.sharded_lut", "ops.voigt", "ops.planck",
             "forward.rt", "spectra", "utils.profiling", "utils.debug",
             "halo_overlap"):
    assert "spectrobot_tpu_torch." + name in sys.modules, name
import chip_smoke
import ablate_basis
import torch
from spectrobot_tpu_torch.data.synth import co2_15um_band
from spectrobot_tpu_torch.forward.model import nadir_single_layer
from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist
dl = device_lines_from_linelist(co2_15um_band(j_max=4), [(2, 1)],
                                dtype=torch.float64, device="cpu")
J = torch.func.jacfwd(lambda T: nadir_single_layer(
    torch.linspace(660.0, 670.0, 64, dtype=torch.float64), dl, T, 500.0,
    2e27, 0.95, 260.0))(torch.tensor(215.0, dtype=torch.float64))
assert bool(torch.isfinite(J).all()) and J.shape == (64,)
for cmd, extra in (("forward", []), ("retrieve", []),
                   ("forward", ["-o", "compute.variant=weideman", "-o",
                                "run.save_optics=true"])):
    sys.argv = ["spectrobot_tpu_torch", cmd, {toml!r}, "--device", "cpu",
                "-o", "run.output_dir=" + {out!r}, "-o", "retrieval.max_iter=2",
                *extra]
    try:
        runpy.run_module("spectrobot_tpu_torch", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
sys.argv = ["spectrobot_tpu_torch.adjoint", "--device", "cpu", "--n-points",
            "64", "--n-lev", "5", "--j-max", "4", "--n-rays", "2",
            "--repeats", "1"]
try:
    runpy.run_module("spectrobot_tpu_torch.adjoint", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
loaded = [k for k, v in sys.modules.items() if v is not None and (
          k in ("jax", "spectrobot_tpu")
          or k.startswith(("jax.", "spectrobot_tpu.")))]
assert not loaded, loaded
if not {block}:
    assert "jax" not in sys.modules and "spectrobot_tpu" not in sys.modules
print("NO_JAX_OK")
"""


@pytest.mark.parametrize("block", [True, False])
def test_port_runs_without_jax(tmp_path, block):
    toml = tmp_path / "tiny.toml"
    toml.write_text(TINY_TOML)
    out = tmp_path / "out"
    # One intra-op thread: the tiny run would only contend with the other
    # test workers for the cores.
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(block=block, toml=str(toml),
                                             out=str(out))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout
    assert "max rel grad diff" in proc.stdout       # the adjoint tool ran
    assert (out / "forward.npz").exists()
    assert (out / "retrieval.npz").exists() and (out / "run.jsonl").exists()
    assert (out / "optics.npz").exists()
