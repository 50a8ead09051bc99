"""BENCHMARK.json against the contract's rules, and every file it names
found by name."""

import json
import math
import re
import shutil
import sys
import tomllib

import pytest

from spectrobench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"expansion|_dim$|_rank$|experts_per_tok)")


@pytest.fixture(scope="module")
def man():
    return manifest.load()


def test_manifest_has_exactly_the_contract_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(man["command"]) <= 32
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert len(json.dumps(man)) <= 64 * 1024


def test_entries_have_only_their_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}


def test_names_and_units_use_the_allowed_characters(man):
    names = ([c["name"] for c in man["configs"]]
             + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in man["configs"]]
                 + [c["source"] for c in man["configs"]]
                 + [w["why"] for w in man["workloads"]]
                 + [m["layer"] for m in man["per_layer"]]
                 + man["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for c in man["configs"]:
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k)


def test_cells_configs_and_metrics_agree(man):
    configs = {c["name"] for c in man["configs"]}
    cells = {w["name"] for w in man["workloads"]}
    used = {w["config"] for w in man["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert 1 <= len(cells) <= 24 and 1 <= len(configs) <= 24
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert all(w["chips"] in (1, 4) for w in man["workloads"])
    assert four <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in man["per_layer"]:
        assert m["source"] in SOURCES and m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        mine = manifest.metrics_for(man, cell, False)
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert manifest.metrics_for(man, cell, True)


@pytest.mark.parametrize("pending", [False, True])
def test_every_named_file_is_found_by_name(pending):
    man = manifest.load(pending=pending)
    for c in man["configs"]:
        path = manifest.REPO / c["file"]
        assert c["file"].startswith(tuple(p + "/" for p in man["paths"]))
        with open(path, "rb") as f:
            bench = tomllib.load(f)["bench"]
        assert set(bench) >= {"source", "reduced", "assumed", "deployment",
                              "chips", "reference", "lines"}
        assert "seed" in bench["lines"]
        assert bench["reduced"] == c["reduced"]
        ref = manifest.reference(bench["reference"])
        for fn in ("inputs", "covers", "configured_scene", "prior",
                   "forward", "jvp", "required_work"):
            assert callable(getattr(ref, fn)), fn
    for w in man["workloads"]:
        t = manifest.traffic(w["traffic"])
        assert callable(manifest.driver(t["kind"]))
        assert manifest.limits(w["name"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_pending_entries_are_of_the_manifest_s_form(man):
    """pending.json's cells obey the rules BENCHMARK.json's do (a bound
    aside: theirs is not set), and BENCHMARK.json alone names none."""
    full = manifest.load(pending=True)
    with open(manifest.HERE / "pending.json") as f:
        pend = json.load(f)
    assert pend["about"]
    for group in manifest.GROUPS:
        names = [e["name"] for e in pend[group]]
        assert not set(names) & {e["name"] for e in man[group]}
        assert [e["name"] for e in full[group]] == (
            [e["name"] for e in man[group]] + names)
    for m in pend["end_to_end"]:
        assert m["bound"] is None
    test_entries_have_only_their_keys(full)
    test_names_and_units_use_the_allowed_characters(full)
    for m in full["end_to_end"]:
        m["bound"] = m["bound"] or 0.25
    test_cells_configs_and_metrics_agree(full)


def test_adding_a_cell_and_a_metric_adds_only_files(man, tmp_path):
    """A copy of the harness with one more configuration, traffic mix,
    metric and cell, each a new file, finds them all by name."""
    root = tmp_path / "spectrobench"
    shutil.copytree(manifest.HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (root / "configs" / "extra.toml").write_text(
        (root / "configs" / "mars15_lte.toml").read_text())
    (root / "traffic" / "forward_long.toml").write_text(
        (root / "traffic" / "forward.toml").read_text().replace(
            "pool = 16", "pool = 32"))
    (root / "metrics" / "extra_metric.fwd.py").write_text(
        "def read(rec):\n    return 42.0\n")
    (root / "limits" / "extra.forward_long.toml").write_text(
        "[rad_gap]\nlimit = 1e-4\n")
    (root / "kinds" / "extra_kind.py").write_text(
        "from spectrobench import drivers\n\n\n"
        "class Driver(drivers.Driver):\n    pass\n")
    (root / "reference" / "extra_scene.py").write_text(
        "def covers(cfg):\n    return None\n")
    new = json.loads(json.dumps(man))
    new["configs"].append({**man["configs"][0], "name": "extra",
                           "file": "spectrobench/configs/extra.toml"})
    new["workloads"].append({"name": "extra.forward_long", "config": "extra",
                             "traffic": "forward_long", "chips": 1,
                             "why": "x"})
    new["per_layer"].append({"name": "extra_metric.fwd", "unit": "ms",
                             "better": "lower", "source": "program_span",
                             "layer": "device", "moves": "setup_s",
                             "workloads": ["extra.forward_long"]})
    saved = manifest.HERE, manifest.REPO
    try:
        manifest.HERE, manifest.REPO = root, tmp_path
        assert manifest.traffic("forward_long")["pool"] == 32
        assert manifest.limits("extra.forward_long") == {"rad_gap": 1e-4}
        got = manifest.metrics_for(new, "extra.forward_long", True)
        assert [m["name"] for m in got] == ["extra_metric.fwd"]
        assert manifest.reader("extra_metric.fwd")({}) == 42.0
        assert manifest.config_path(new, "extra").exists()
        assert manifest.driver("extra_kind").__name__ == "Driver"
        assert manifest.reference("extra_scene").covers(None) is None
    finally:
        manifest.HERE, manifest.REPO = saved
        for name in ("kinds.extra_kind", "reference.extra_scene"):
            sys.modules.pop("spectrobench." + name, None)


def test_run_seconds_fits_the_check_with_every_cell(man):
    rs = man["run_seconds"]
    total = (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
    assert not math.isnan(rs)
