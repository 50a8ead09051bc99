"""The inputs repeat per seed, and every seed draws the same sizes."""

import numpy as np

from spectrobench import manifest
from spectrobench.inputs import make_inputs, smooth_profiles, rng

from spectrobench.tests.conftest import SMALL


def _inputs(seed, tmp_path, traffic="forward"):
    man = manifest.load()
    return make_inputs(manifest.config_path(man, "mars15_lte"),
                       manifest.traffic(traffic), seed, str(tmp_path),
                       SMALL)


def test_same_seed_same_inputs(tmp_path):
    big = 2 ** 31 + 12345
    a, b = _inputs(big, tmp_path / "a"), _inputs(big, tmp_path / "b")
    for k in a.scene.lines:
        np.testing.assert_array_equal(a.scene.lines[k], b.scene.lines[k])
    for p, q in zip(a.pool, b.pool):
        np.testing.assert_array_equal(p["T"], q["T"])
        np.testing.assert_array_equal(p["vmr"], q["vmr"])
    assert a.cfg == b.cfg or a.cfg.lines.source != b.cfg.lines.source


def test_other_seed_other_inputs_of_the_same_sizes(tmp_path):
    a, b = _inputs(1, tmp_path / "a"), _inputs(2, tmp_path / "b")
    # One catalog for the configuration (its file fixes the draw).
    np.testing.assert_array_equal(a.scene.lines["nu0"], b.scene.lines["nu0"])
    assert not np.array_equal(a.pool[0]["T"], b.pool[0]["T"])
    base = a.scene.atm["T"]
    size = lambda inp: sorted(np.abs(p["T"] - base).max() for p in inp.pool)
    np.testing.assert_allclose(size(a), size(b))
    assert max(size(a)) <= 10.0 + 1e-9


def test_a_fixed_campaign_changes_only_its_order(tmp_path):
    a = _inputs(1, tmp_path / "a", "retrieve")
    b = _inputs(2, tmp_path / "b", "retrieve")
    for p, q in zip(a.pool, b.pool):
        np.testing.assert_array_equal(p["T"], q["T"])
    assert sorted(a.order) == sorted(b.order) == list(range(len(a.pool)))
    assert list(a.order) != list(b.order)


def test_the_catalog_is_the_reference_bench_draw(tmp_path):
    from spectrobot_tpu_torch.data.synth import random_lines
    man = manifest.load()
    inp = make_inputs(manifest.config_path(man, "mars15_lte"),
                      manifest.traffic("forward"), 9, str(tmp_path))
    bench = random_lines(2048, 600.0, 750.0, seed=3)
    np.testing.assert_array_equal(inp.scene.lines["nu0"], bench.nu0)


def test_the_program_reads_the_seeds_files(tmp_path):
    inp = _inputs(5, tmp_path)
    assert inp.cfg.lines.source.startswith(str(tmp_path))
    assert inp.cfg.scene.atmosphere.startswith(str(tmp_path))
    with np.load(inp.cfg.lines.source) as z:
        np.testing.assert_array_equal(np.sort(z["nu0"]),
                                      inp.scene.lines["nu0"])


def test_smooth_profiles_keep_their_sizes():
    z = np.linspace(0.0, 80e3, 32)
    p = smooth_profiles(rng(3, 1), 8, z, 10.0, 4)
    np.testing.assert_allclose(sorted(np.abs(p).max(1)),
                               10.0 * np.arange(1, 9) / 8)


def test_the_campaign_s_truths_are_computed_once(tmp_path, monkeypatch):
    """The reference's spectra of a retrieval campaign's truths are kept
    in the benchmark's cache and read back by a later run of the same
    inputs; other inputs miss."""
    import torch

    a = _inputs(1, tmp_path / "a", "retrieve")
    drive = manifest.driver("retrieve")
    first = drive(a, torch.device("cpu"))._truth_spectra()
    cached = list((tmp_path / "cache" / "spectrobench").glob("truths-*"))
    assert len(cached) == 1

    def refuse(*args, **kw):
        raise AssertionError("computed again")
    with monkeypatch.context() as m:
        m.setattr(a.ref, "forward", refuse)
        b = _inputs(2, tmp_path / "b", "retrieve")
        np.testing.assert_array_equal(
            drive(b, torch.device("cpu"))._truth_spectra(), first)
    c = make_inputs(manifest.config_path(manifest.load(), "mars15_lte"),
                    manifest.traffic("retrieve"), 1, str(tmp_path / "c"),
                    {**SMALL, "scene.n_levels": "9"})
    drive(c, torch.device("cpu"))._truth_spectra()
    assert len(list((tmp_path / "cache" / "spectrobench").glob(
        "truths-*"))) == 2
