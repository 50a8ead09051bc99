"""The readers of the program's own spans and counters (``jac_*_ms``,
``lm_algebra_ms``, ``jacobian_repeat_pct``) on planted records: two
Jacobians, one inside an LM iteration and one after the loop, and the
LM counts; and nothing read without a traced segment or units, or where
the program's bounded list of spans let records go."""

import pytest

from spectrobench import manifest
from spectrobot_tpu_torch.retrieval import oe
from spectrobot_tpu_torch.utils import profiling

SPAN_METRICS = ("jac_prologue_ms", "jac_line_sum_ms", "jac_epilogue_ms",
                "lm_algebra_ms")


def _span(i, name, parent, device_ms=None, host_ms=0.0):
    return {"id": i, "name": name, "parent": parent, "host_ms": host_ms,
            "device_ms": device_ms}


def _phases(first, jac, scale):
    """A forward's five phases under ``jac`` (a Jacobian, an LM iteration
    or None), device times 1, 2, 10, 5 and 0.5 ms times ``scale``."""
    times = {"path": 1.0, "prologue": 2.0, "line_sum": 10.0,
             "epilogue": 5.0, "ils": 0.5}
    return [_span(first + k, f"spectrobot.forward.{n}", jac, t * scale)
            for k, (n, t) in enumerate(times.items())]


SPANS = ([_span(0, "spectrobot.lm.iteration", None, 40.0, 30.0),
          _span(1, "spectrobot.jacobian", 0, 25.0)]
         + _phases(2, 1, 1.0)
         + [_span(7, "spectrobot.lm.normal_equations", 0, None, 0.25),
            _span(8, "spectrobot.lm.solve", 0, None, 0.125),
            # The trial forward: outside every Jacobian.
            *_phases(9, 0, 100.0),
            _span(14, "spectrobot.lm.cost", 0, None, 0.0625),
            _span(15, "spectrobot.lm.iteration", None, 1.0, 1.0),
            _span(16, "spectrobot.lm.cost", 15, None, 0.5),
            _span(17, "spectrobot.jacobian", None, 50.0)]
         + _phases(18, 17, 2.0)
         + [_span(23, "spectrobot.lm.posterior", None, None, 1.0)])
TRACE = [{"window_us": 1.0, "units": [(0.0, 1.0)], "events": []}]


@pytest.fixture
def planted(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [dict(s) for s in SPANS])
    monkeypatch.setattr(profiling, "dropped_spans", lambda: 0)
    monkeypatch.setattr(oe, "COUNTS", {"jacobians": 12,
                                       "jacobians_repeated": 3})
    return {"units": [{"n_iter": 3}], "trace": TRACE}


@pytest.mark.parametrize("name,want", [
    ("jac_prologue_ms", (3.0 + 6.0) / 2),
    ("jac_line_sum_ms", (10.0 + 20.0) / 2),
    ("jac_epilogue_ms", (5.5 + 11.0) / 2),
    ("lm_algebra_ms", (0.25 + 0.125 + 0.0625 + 0.5 + 1.0) / 2),
    ("jacobian_repeat_pct", 100.0 * 3 / 12),
])
def test_reader_arithmetic(planted, name, want):
    assert manifest.reader(name)(planted) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name,needs", [(n, "trace") for n in SPAN_METRICS]
                         + [("jacobian_repeat_pct", "units")])
def test_readers_need_their_records(planted, name, needs):
    """No traced segment (the span readers) or no units (the counter's):
    None, whatever the program holds."""
    assert manifest.reader(name)({"units": [], "trace": None}) is None
    assert manifest.reader(name)({**planted, needs: []}) is None


@pytest.mark.parametrize("name", SPAN_METRICS + ("jacobian_repeat_pct",))
def test_readers_find_nothing_in_a_program_without_them(planted, monkeypatch,
                                                        name):
    """A program without the span records or the counts (the parent of
    their change) gives no reading, and no error."""
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(oe, "COUNTS")
    assert manifest.reader(name)(planted) is None


@pytest.mark.parametrize("name", SPAN_METRICS[:3])
def test_jacobian_readers_skip_spans_without_device_time(planted,
                                                         monkeypatch, name):
    """On the CPU the spans carry no device time: no reading."""
    cpu = [{**s, "device_ms": None} for s in SPANS]
    monkeypatch.setattr(profiling, "spans", lambda: cpu)
    assert manifest.reader(name)(planted) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_read_nothing_from_a_cut_list(planted, monkeypatch,
                                                   name):
    """Where the program's bounded list dropped records, a mean over what
    is left would change without a sign: no reading."""
    monkeypatch.setattr(profiling, "dropped_spans", lambda: 1)
    assert manifest.reader(name)(planted) is None
