"""Each metric's arithmetic on a recorded synthetic run: host spans of a
window and a traced segment of two cards with known device intervals."""

import pytest

from spectrobench import manifest


def _rec():
    units = [
        {"wall_s": 0.5, "converged": True, "n_iter": 3,
         "forward_s": [0.01, 0.01, 0.01, 0.01], "jacobian_s": [0.07, 0.07,
                                                              0.07, 0.07]},
        {"wall_s": 0.7, "converged": False, "n_iter": 5,
         "forward_s": [0.01] * 6, "jacobian_s": [0.08] * 6},
    ]
    # Two cards, 1000 us each; card 0: K1 100 us, K2 300 us, the ring 50 us
    # of which 30 us alone; card 1: K1 100 us, the ring 30 us all alone.
    t0 = {"window_us": 1000.0, "units": [(0.0, 1000.0)], "events": [
        ("opacity_batch_kernel", 0.0, 100.0, 7),
        ("basis_batch_kernel", 100.0, 400.0, 7),
        ("dma_ring_kernel", 380.0, 430.0, 9)]}
    t1 = {"window_us": 1000.0, "units": [(0.0, 1000.0)], "events": [
        ("opacity_batch_kernel", 0.0, 100.0, 7),
        ("dma_ring_kernel", 200.0, 230.0, 9)]}
    return {"setup_s": 12.5, "window_s": 2.0, "units": units,
            "trace": [t0, t1], "work": {"k1_ms": [0.02, 0.03],
                                        "k2_ms": [0.06]}, "chips": 2}


@pytest.mark.parametrize("name,want", [
    ("setup_s", 12.5),
    ("retrievals_per_s", 0.5),
    ("retrieval_p90_s", 0.68),
    ("lm_iters_per_retrieval", 4.0),
    ("lm_host_ms", 1e3 * ((0.5 - 0.04 - 0.28) + (0.7 - 0.06 - 0.48)) / 8),
    ("jacobian_ms", 1e3 * (0.28 + 0.48) / 10),
    ("k1_roofline.retrieve", 100.0 * 50.0 / 200.0),
    ("k1_roofline.forward", 100.0 * 50.0 / 200.0),
    ("k2_roofline", 100.0 * 60.0 / 300.0),
    ("device_idle_pct.retrieve", 100.0 * (1 - (430 / 1000 + 130 / 1000) / 2)),
    ("device_idle_pct.forward", 100.0 * (1 - (430 / 1000 + 130 / 1000) / 2)),
    ("mfu_pct.retrieve", 100.0 * 0.11 / 2.0),
    ("mfu_pct.forward", 100.0 * 0.11 / 2.0),
    ("halo_exposed_ms", 0.030),
])
def test_metric_arithmetic(name, want):
    assert manifest.reader(name)(_rec()) == pytest.approx(want, rel=1e-9)


def test_forward_metrics():
    rec = {"window_s": 2.0, "units": [
        {"wall_s": 0.004 + 0.001 * i, "issue_s": 0.003, "pool": i % 3}
        for i in range(21)]}
    assert manifest.reader("spectra_per_s")(rec) == 10.5
    assert manifest.reader("host_issue_ms.forward")(rec) == pytest.approx(3.0)
    assert manifest.reader("spectrum_p95_ms.forward")(rec) == pytest.approx(
        4.0 + 0.95 * 20)


def test_readers_find_nothing_without_their_records():
    bare = {"setup_s": 1.0, "window_s": 1.0, "units": [], "trace": None,
            "work": None}
    for m in manifest.load()["per_layer"]:
        assert manifest.reader(m["name"])(bare) is None, m["name"]
    one = dict(_rec(), trace=[_rec()["trace"][0]])
    assert manifest.reader("halo_exposed_ms")(one) is None
    none = dict(_rec(), work={"k1_ms": [], "k2_ms": []})
    assert manifest.reader("k2_roofline")(none) is None
