"""The PyTorch port stands alone: importing ``mxnet_tpu_torch`` and all its
submodules loads neither JAX nor any module of the JAX package, and no
source file of the port imports them."""
import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "mxnet_tpu_torch"


def _foreign(name: str) -> bool:
    """jax, or the JAX package — mind the prefix the port shares."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "mxnet_tpu")


def test_import_loads_no_jax_and_no_reference_module():
    script = (
        "import importlib, json, pkgutil, sys\n"
        "import mxnet_tpu_torch as m\n"
        "for info in pkgutil.walk_packages(m.__path__, 'mxnet_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "jax" not in mods
    assert [m for m in mods if _foreign(m)] == []
    # every submodule was really imported
    subs = {i.name for i in pkgutil.walk_packages([str(PKG)],
                                                  "mxnet_tpu_torch.")}
    assert subs and subs <= set(mods)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_reference(path):
    assert [m for m in _imports(path) if _foreign(m)] == []


def test_chip_smoke_imports_no_jax_and_no_reference():
    assert [m for m in _imports(ROOT / "chip_smoke.py") if _foreign(m)] == []


def test_foreign_predicate_minds_the_shared_prefix():
    assert _foreign("mxnet_tpu") and _foreign("mxnet_tpu.ops.nn")
    assert _foreign("jax.numpy")
    assert not _foreign("mxnet_tpu_torch") and \
        not _foreign("mxnet_tpu_torch.ops")
