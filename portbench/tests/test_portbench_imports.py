"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Names are compared by their
top-level part whole, so `ozone_tpu_torch` is not `ozone_tpu`."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "ozone_tpu"}
PB = ROOT / "portbench"


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".", 1)[0]


def _files():
    return sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(p.relative_to(PB)))
def test_no_file_imports_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((PB / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "ozone_tpu_torch" not in set(_imports(path))
    assert not set(_imports(path)) & FORBIDDEN


def test_names_are_compared_whole():
    assert "ozone_tpu_torch".split(".", 1)[0] not in FORBIDDEN


def test_loaded_harness_leaves_no_jax_in_sys_modules():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench import run\n"
        "from portbench.harness import cell, spec, system, trace, check\n"
        "import ozone_tpu_torch.testing.minicluster, ozone_tpu_torch.codec.service\n"
        "import pathlib\n"
        "for kind in ('metrics', 'end_to_end'):\n"
        "    for p in pathlib.Path('portbench', kind).glob('*.py'):\n"
        "        spec.reader(kind, p.stem)\n"
        "print(','.join(run.forbidden_modules()))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == ""
