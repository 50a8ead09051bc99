"""The profiling and debug utilities of the PyTorch port
(spectrobot_tpu_torch/utils/profiling.py, utils/debug.py):
tests/test_obs.py's two checks on the port, the trace's contents and
kernel_roofline against the reference's arithmetic."""

import json
import os

import numpy as np
import pytest
import torch

from spectrobot_tpu.utils.profiling import kernel_roofline as j_roofline
from spectrobot_tpu_torch.utils.debug import assert_finite, checked
from spectrobot_tpu_torch.utils.profiling import (
    annotate, kernel_roofline, stopwatch, trace)
from spectrobot_tpu_torch.utils.runlog import RunLogger

torch.set_num_threads(1)


def test_profiling_utils(tmp_path, capsys):
    log = RunLogger(str(tmp_path / "t.jsonl"))
    with stopwatch("stage", sink=log):
        pass
    with stopwatch("to stderr"):
        pass
    assert "[stopwatch] to stderr: " in capsys.readouterr().err
    with open(tmp_path / "t.jsonl") as f:
        rec = [json.loads(line) for line in f]
    assert rec[-1]["stage"] == "stage" and rec[-1]["wall_s"] >= 0.0
    info = kernel_roofline(n_pairs=1e9, wall_s=0.05)
    assert info["pairs_per_s"] == 2e10
    assert info["arithmetic_intensity_flops_per_byte"] > 100
    assert info == j_roofline(n_pairs=1e9, wall_s=0.05)
    assert kernel_roofline(3e8, 0.2, 14.0, 1.5) == j_roofline(3e8, 0.2, 14.0,
                                                              1.5)
    with trace(str(tmp_path / "trace")) as prof:
        with annotate("opacity"):
            x = torch.ones((8,)) * 2.0
            torch.sum(x)
    path = tmp_path / "trace" / "trace.json"
    assert os.path.getsize(path) > 0
    assert "opacity" in path.read_text()
    assert any(e.key == "opacity" for e in prof.key_averages())


def test_debug_utils(capsys):
    g = checked(torch.log)
    err, out = g(torch.tensor([1.0, 2.0]))
    err.throw()                       # clean input: no raise
    assert err.get() is None
    np.testing.assert_allclose(out.numpy(), np.log([1.0, 2.0]))
    err, _ = g(torch.tensor([-1.0]))  # NaN
    with pytest.raises(FloatingPointError, match="non-finite"):
        err.throw()
    err, out = checked(lambda a: a[5])(torch.zeros(2))
    assert out is None
    with pytest.raises(FloatingPointError, match="IndexError"):
        err.throw()
    err, _ = checked(lambda a: (a, {"b": 1.0 / a}))(torch.zeros(1))
    with pytest.raises(FloatingPointError, match=r"\[1\]"):
        err.throw()

    h = lambda x: assert_finite("h", x) * 2.0
    np.testing.assert_allclose(h(torch.tensor([1.0, 2.0])).numpy(),
                               [2.0, 4.0])
    assert capsys.readouterr().out == ""
    h(torch.tensor([1.0, float("inf")]))
    assert capsys.readouterr().out == \
        "[spectrobot_tpu] NON-FINITE values in h\n"
    # Under vmap the values are not readable: the tensor passes through.
    np.testing.assert_allclose(
        torch.func.vmap(h)(torch.ones(3, 2)).numpy(), 2.0)
