"""A run's last line: exactly the contract's keys (``breakdown`` when
traced, the numbers compared last), each metric of the cell read."""

import time

import pytest
import torch

from spectrobench import manifest, run
from spectrobench.tests.conftest import SMALL


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    man = manifest.load(pending=True)
    rec = run.run_cell("mars15_lte.forward", 3, 0.1, trace,
                       torch.device("cpu"), time.time(), man,
                       overrides=SMALL, max_units=2)
    out = run.result_line(rec, man, trace)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == want + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    names = {m["name"] for m in manifest.metrics_for(man,
                                                     "mars15_lte.forward",
                                                     trace)}
    assert set(out["metrics"]) <= names
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(out["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(out["metrics"]) == names
    assert set(out["checks"]) == {"rad_gap"}
    assert out["checks"]["rad_gap"]["value"] <= out["checks"]["rad_gap"][
        "limit"]


def test_a_run_without_enough_cards_fails_and_prints_nothing(capsys,
                                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "mars15_lte.retrieve", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_set_up_leaves_out_the_reference_s_own_work(monkeypatch):
    """Seconds a driver's set-up spends on the reference (``reference_s``)
    are not in ``setup_s``."""
    man = manifest.load(pending=True)
    drive = manifest.driver("forward")
    real = drive.setup

    def slow(self):
        real(self)
        time.sleep(4.0)
        self.reference_s = 4.0

    def setup_s():
        return run.run_cell("mars15_lte.forward", 3, 0.1, False,
                            torch.device("cpu"), time.time(), man,
                            overrides=SMALL, max_units=1)["setup_s"]
    plain = setup_s()
    monkeypatch.setattr(drive, "setup", slow)
    assert abs(setup_s() - plain) < 2.0
