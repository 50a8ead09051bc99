"""Every fault a cell can have, planted under the timed path, turns the
run's ``correct`` false: the harness's look for a chip skipped (the CPU,
the kernels' plain versions, a small scene), the rest of a run driven as
it is."""

import json
import os
import socket
import time

import numpy as np
import pytest
import torch

from spectrobench import manifest, run
from spectrobench.tests.conftest import SMALL, SMALL_FINE4


def _run(cell, overrides=SMALL, max_units=2):
    man = manifest.load(pending=True)
    rec = run.run_cell(cell, 11, 0.1, False, torch.device("cpu"),
                       time.time(), man, overrides=overrides,
                       max_units=max_units)
    return run.result_line(rec, man, False)


def _wrap_forward(monkeypatch, change):
    """The CLI's forward with ``change(y [R, C]) -> y`` applied to its
    radiances where they are produced."""
    from spectrobot_tpu_torch import cli
    real = cli.scene_forward

    def scene_forward(cfg, *a, **kw):
        f = real(cfg, *a, **kw)
        n_rays = len(cfg.geometry.tangent_heights_km)
        return lambda s: change(f(s).reshape(n_rays, -1)).reshape(-1)
    monkeypatch.setattr(cli, "scene_forward", scene_forward)


def _half_rays(y):
    keep = torch.arange(y.shape[0]) < (y.shape[0] + 1) // 2
    return y * keep[:, None].to(y.dtype)


def test_sound_runs_are_correct():
    assert _run("mars15_lte.forward")["correct"] is True
    assert _run("mars15_lte.retrieve", max_units=1)["correct"] is True


@pytest.mark.parametrize("cell,units", [("mars15_lte.forward", 2),
                                        ("mars15_lte.retrieve", 1)])
def test_an_answer_altered_where_it_is_produced(monkeypatch, cell, units):
    _wrap_forward(monkeypatch, lambda y: y * (1.0 + 1e-3))
    out = _run(cell, max_units=units)
    assert out["correct"] is False


@pytest.mark.parametrize("cell,units", [("mars15_lte.forward", 2),
                                        ("mars15_lte.retrieve", 1)])
def test_half_of_the_batch_left_out(monkeypatch, cell, units):
    _wrap_forward(monkeypatch, _half_rays)
    assert _run(cell, max_units=units)["correct"] is False


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from spectrobench.calibrate import plant_step_unchanged
    from spectrobot_tpu_torch.retrieval import oe
    monkeypatch.setattr(oe, "_lm_solve", oe._lm_solve)
    plant_step_unchanged()
    out = _run("mars15_lte.retrieve", max_units=1)
    assert out["correct"] is False


def test_a_retrieved_state_altered_where_it_is_produced(monkeypatch):
    from spectrobot_tpu_torch.retrieval import oe
    real = oe.retrieve

    def altered(*a, **kw):
        res = real(*a, **kw)
        res.x = res.x + 1.0
        return res
    monkeypatch.setattr(oe, "retrieve", altered)
    assert _run("mars15_lte.retrieve", max_units=1)["correct"] is False


def _mesh_rank(r, n, port, out_dir, fault):
    os.environ.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    if fault:
        from spectrobot_tpu_torch.parallel import sharded
        real = sharded.ring_exchange_start

        def left_out(*a, **kw):
            pending = real(*a, **kw)
            got = pending.wait()
            zeros = [[torch.zeros_like(m) for m in hop] for hop in got]
            return type(pending)((), (), zeros)
        sharded.ring_exchange_start = left_out
    man = manifest.load(pending=True)
    rec = run.run_cell("mars15_lte_fine4.forward", 11, 0.1, False,
                       torch.device("cpu"), time.time(), man,
                       overrides=SMALL_FINE4, max_units=1)
    if rec["check"] is not None:
        with open(os.path.join(out_dir, "out.json"), "w") as f:
            json.dump(run.result_line(rec, man, False), f)


@pytest.mark.parametrize("fault", [False, True])
def test_the_exchange_between_chips_left_out(tmp_path, fault):
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_mesh_rank, args=(4, port, str(tmp_path), fault), nprocs=4)
    with open(tmp_path / "out.json") as f:
        out = json.load(f)
    assert out["device"]["count"] == 4
    assert out["correct"] is (not fault)
    if fault:
        assert not np.isfinite(out["checks"]["rad_gap"]["value"]) or \
            out["checks"]["rad_gap"]["value"] > 10 * out["checks"][
                "rad_gap"]["limit"]
