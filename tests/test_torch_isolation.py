"""The PyTorch port stands alone: importing ``mxnet_tpu_torch`` and all its
submodules loads neither JAX nor any module of the JAX package, and no
source file of the port imports them."""
import ast
import json
import os
import pkgutil
import re
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


HOST_PLANES = ("checkpoint", "faults", "lockwatch", "profiler",
               "telemetry", "serve.server", "serve.router", "serve.chaos",
               "serve.bench", "serve.faults", "serve.supervise",
               "serve.__main__", "io.data_service", "obs", "obs.recorder",
               "obs.signals", "obs.rules", "obs.fleet", "obs.check",
               "obs.__main__", "tracecheck", "tracemerge",
               "models.model_store", "gluon.utils")


def test_host_planes_import_alone_under_the_lock_watchdog():
    """The train → checkpoint → serve modules and the observed fleet's
    (the data service, obs, the trace gate and merge, the model store),
    each imported in a fresh process with ``MXNET_LOCK_CHECK=1`` (the
    chaos replicas' and the obs fleet's setting): the watchdog is
    installed, nothing of JAX or the JAX package loads, and neither
    ``serve.__main__`` nor ``obs.__main__`` runs when imported."""
    script = (
        "import importlib, json, sys\n"
        "for m in sys.argv[1:]:\n"
        "    importlib.import_module('mxnet_tpu_torch.' + m)\n"
        "from mxnet_tpu_torch import lockwatch\n"
        "print(json.dumps([lockwatch.installed(), sorted(sys.modules)]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), MXNET_LOCK_CHECK="1")
    out = subprocess.run([sys.executable, "-c", script, *HOST_PLANES],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    installed, mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert installed
    assert [m for m in mods if _foreign(m)] == []
    assert {f"mxnet_tpu_torch.{m}" for m in HOST_PLANES} <= set(mods)


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


HOST_SOURCES = sorted((PKG / "csrc_host").glob("*"))


@pytest.mark.parametrize("path", HOST_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_host_stage_source_includes_nothing_of_the_reference(path):
    """The input path's C++ stage is the port's own copy: it includes no
    header of the reference's ``src/`` by path and names not its
    library."""
    text = path.read_text()
    quoted = re.findall(r'#include\s+"([^"]+)"', text)
    assert all("/" not in q and (PKG / "csrc_host" / q).exists()
               for q in quoted), quoted
    assert "libmxtpu_rt" not in text and "mxtpu/" not in text


def test_host_stage_build_reads_only_its_own_sources():
    from mxnet_tpu_torch import _host_build
    cmd = _host_build._command("g++", ROOT / "build" / "x.so")
    inc = [c for c in cmd if c.startswith("-I")]
    assert f"-I{PKG / 'csrc_host'}" in inc
    assert not [c for c in cmd if str(ROOT / "src") in c or
                "mxnet_tpu/" in c.replace("mxnet_tpu_torch/", "")]
    assert [str(s) for s in _host_build.SOURCES] == \
        [str(PKG / "csrc_host" / "dataio.cc")]


def test_input_path_never_loads_the_reference_library(tmp_path):
    """Decode, encode, resize and the native loader in a fresh process:
    its maps hold the port's stage and no ``libmxtpu_rt.so``."""
    script = (
        "import json, numpy as np\n"
        "from mxnet_tpu_torch import image, recordio, io\n"
        "img = (np.arange(48 * 40 * 3) % 251).astype(np.uint8)"
        ".reshape(48, 40, 3)\n"
        "rec = recordio.MXIndexedRecordIO('t.idx', 't.rec', 'w')\n"
        "for i in range(4):\n"
        "    rec.write_idx(i, recordio.pack_img((0, i, i, 0), img))\n"
        "rec.close()\n"
        "image.imresize(image.imdecode(image.imencode(img)), 20, 20)\n"
        "it = io.NativeImageRecordIter('t.rec', (3, 32, 32), 2)\n"
        "it.next_raw()\n"
        "maps = open('/proc/self/maps').read()\n"
        "import sys\n"
        "print(json.dumps(['libmxtpu_rt' in maps,\n"
        "                  'libmxnet_tpu_torch_dataio' in maps,\n"
        "                  sorted(m for m in sys.modules\n"
        "                         if m.split('.')[0] in ('jax', 'mxnet_tpu'))"
        "]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    ref_lib, own_lib, foreign = json.loads(out.stdout.strip().splitlines()[-1])
    assert not ref_lib and own_lib and foreign == []
