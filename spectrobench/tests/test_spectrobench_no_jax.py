"""Nothing under spectrobench/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
nothing reads the JAX package's benchmarks."""

import ast
import subprocess
import sys

from spectrobench import manifest
from spectrobench.run import FORBIDDEN, forbidden_modules

HERE = manifest.HERE


def _sources():
    return sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in
                  p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops = [node.module.split(".")[0]]
            else:
                continue
            for top in tops:
                assert top not in FORBIDDEN, f"{path}: imports {top}"


def test_nothing_reads_the_jax_benchmarks():
    """No harness module names the JAX package's benchmark folder or
    imports the root ``bench`` module."""
    for path in _sources():
        if "tests" in path.relative_to(HERE).parts:
            continue
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert "benchmarks/" not in node.value, path
            if isinstance(node, ast.Import):
                assert all(a.name != "bench" for a in node.names), path


def test_a_run_process_loads_neither():
    """Every module of the harness imported in a fresh interpreter that
    refuses JAX and the JAX package."""
    mods = ["spectrobench." + ".".join(p.relative_to(HERE).with_suffix(
        "").parts) for p in _sources() if "tests" not in p.parts
        and "metrics" not in p.parts and p.name != "__main__.py"]
    code = (
        "import sys, importlib.abc\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}:\n"
        "    __import__(m)\n"
        "import spectrobot_tpu_torch.cli\n"
        "import spectrobot_tpu_torch.parallel.sharded\n"
        "from spectrobench import manifest\n"
        "man = manifest.load()\n"
        "for m in man['end_to_end'] + man['per_layer']:\n"
        "    manifest.reader(m['name'])\n"
        "from spectrobench.run import forbidden_modules\n"
        "assert forbidden_modules() == [], forbidden_modules()\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(manifest.REPO))
    assert out.returncode == 0, out.stderr[-2000:]


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "spectrobot_tpu_torch_extra", object())
    assert "spectrobot_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "spectrobot_tpu.ops", object())
    assert forbidden_modules() == ["spectrobot_tpu"]


def _rank(r, n, port, out_dir, planted):
    """One gloo rank of the four-card cell at a small size, ending as a
    run's rank does; rank ``planted`` holds a JAX module once its window
    has closed."""
    import json
    import os
    import time

    import torch

    from spectrobench import run
    from spectrobench.tests.conftest import SMALL_FINE4
    os.environ.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    man = manifest.load(pending=True)
    rec = run.run_cell("mars15_lte_fine4.forward", 11, 0.1, False,
                       torch.device("cpu"), time.time(), man,
                       overrides=SMALL_FINE4, max_units=1)
    if r == planted:
        sys.modules["jax"] = object()
    code = run.conclude(rec, man, False)
    with open(os.path.join(out_dir, f"code{r}.json"), "w") as f:
        json.dump(code, f)


def test_every_rank_fails_that_holds_jax_after_its_window(tmp_path):
    import json
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(4, port, str(tmp_path), 2), nprocs=4)
    codes = [json.loads((tmp_path / f"code{r}.json").read_text())
             for r in range(4)]
    assert codes[2] != 0
    assert codes[0] == codes[1] == codes[3] == 0
