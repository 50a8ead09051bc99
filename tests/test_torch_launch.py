"""The port's one launch seam (spectrobot_tpu_torch/kernels/launch.py) on
the CPU, where no kernel is built:

- ``launch.KERNELS`` lists every kernel source ``csrc/*.cu``, so none is
  left out of the launch counts and of their reading from a trace;
- nothing under ``ops/`` or ``kernels/`` imports the mesh's ``parallel/``
  (an AST walk over every import, function-level ones included);
- a :class:`launch.Kernel` call counts its launch by its ``__global__``
  name and raises one RuntimeError form on a non-zero code.

The kernels themselves launch on the card (tests/test_torch_cuda.py)."""

import ast
import pathlib

import pytest

from spectrobot_tpu_torch.kernels import build, launch

PACKAGE = pathlib.Path(build.PACKAGE_DIR)


def test_kernels_list_every_kernel_source():
    assert set(launch.KERNELS) == {p.stem for p in
                                   build.SOURCE_DIR.glob("*.cu")}


def _imports(path: pathlib.Path) -> list:
    """Every module an import statement of ``path`` names (for ``from m
    import a``, ``m`` and ``m.a``)."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: a relative import"
            out += [node.module] + [f"{node.module}.{a.name}"
                                    for a in node.names]
    return out


@pytest.mark.parametrize("layer", ["ops", "kernels"])
def test_lower_layers_never_import_parallel(layer):
    files = sorted((PACKAGE / layer).glob("*.py"))
    assert files
    bad = {f.name: m for f in files for m in _imports(f)
           if m == "spectrobot_tpu_torch.parallel"
           or m.startswith("spectrobot_tpu_torch.parallel.")}
    assert bad == {}


class _Library:
    """A stand-in for a bound library: ``opacity_batch_launch`` returns
    ``rc`` and records its arguments."""

    def __init__(self, rc: int):
        self.rc, self.calls = rc, []

    def opacity_batch_launch(self, *args):
        self.calls.append(args)
        return self.rc

    def opacity_batch_error_string(self, rc):
        return b"an error"


def test_kernel_call_counts_and_raises():
    kernel = launch.Kernel("opacity_batch", [])
    assert kernel.kernel == "opacity_batch_kernel" and kernel.bound is None
    before = launch.LAUNCHES.copy()
    try:
        kernel.bound = _Library(0)
        kernel(1, 2)
        assert kernel.bound.calls == [(1, 2)]
        assert launch.LAUNCHES - before == {"opacity_batch_kernel": 1}
        kernel.bound = _Library(700)
        with pytest.raises(RuntimeError, match=r"^opacity_batch kernel "
                           r"launch failed: CUDA error 700 \(an error\)$"):
            kernel()
        # A failed launch was made, and counts.
        assert launch.LAUNCHES - before == {"opacity_batch_kernel": 2}
    finally:
        launch.LAUNCHES.clear()
        launch.LAUNCHES.update(before)
    with pytest.raises(KeyError):
        launch.Kernel("not_a_kernel", [])
