"""The port stands alone: no file of mxnet_tpu_torch (nor chip_smoke.py)
imports jax or mxnet_tpu, importing the package loads neither, and triton is
imported only inside the functions that launch a kernel."""
import ast
import os
import subprocess
import sys

import pytest
from test_torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mxnet_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, ROOT) for p in out)


def _imported(node):
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [node.module or ""]
    return []


@pytest.mark.parametrize("rel", _sources())
def test_no_jax_or_mxnet_tpu_import(rel):
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read(), rel)
    for node in ast.walk(tree):
        for name in _imported(node):
            assert name.split(".")[0] not in FORBIDDEN, \
                "%s:%d imports %s" % (rel, node.lineno, name)
    # triton only inside functions: never at module level
    for node in tree.body:
        for name in _imported(node):
            assert name.split(".")[0] != "triton", \
                "%s:%d imports triton at module level" % (rel, node.lineno)


def test_package_import_loads_neither():
    code = ("import sys, mxnet_tpu_torch\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in %r + ('triton',))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


IMAGE_SLICE = ("recordio", "image", "visualization", "test_utils",
               "module.sequential_module", "module.python_module",
               "bench.im2rec")


@pytest.mark.parametrize("name", IMAGE_SLICE)
def test_image_slice_modules_stand_alone(name):
    """The image slice's modules import without jax, mxnet_tpu, PIL, cv2
    or graphviz (each is imported at the call that needs it), and the
    package exports them as the JAX package does."""
    code = ("import sys, importlib, mxnet_tpu_torch as mt\n"
            "importlib.import_module('mxnet_tpu_torch.%s')\n"
            "assert mt.viz is mt.visualization and mt.io.ImageRecordIter\n"
            "assert mt.mod.SequentialModule and mt.mod.PythonLossModule\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             %r + ('triton', 'PIL', 'cv2', 'graphviz'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n" % (name, FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_c_api_bridge_embeds_only_the_port():
    """csrc/c_api.cc (the port's C API library) imports one Python module,
    mxnet_tpu_torch.capi, and names no module of the JAX package."""
    import re
    with open(os.path.join(PKG, "csrc", "c_api.cc")) as f:
        text = f.read()
    imported = re.findall(r'PyImport_\w+\(\s*"([^"]+)"', text)
    assert imported == ["mxnet_tpu_torch.capi"]
    code = "\n".join(line for line in text.splitlines()
                     if not line.startswith("#include"))
    named = set(re.findall(r'"(mxnet_tpu[\w.]*|jax[\w.]*)', code))
    assert named == {"mxnet_tpu_torch.capi"}, named
    assert "PyImport_Import(" not in text and "PyRun_" not in text


DIST_SLICE = ("parallel.dist", "parallel.elastic", "checkpoint", "launch",
              "bench.dist_sync_kvstore", "bench.dist_mlp", "parallel.mesh",
              "parallel.placement", "bench.zero_ladder")


@pytest.mark.parametrize("name", DIST_SLICE)
def test_dist_slice_modules_stand_alone(name):
    """The distributed slice's modules import without jax or mxnet_tpu,
    and importing one brings up no process group and starts no thread
    (the world comes up at the first call that needs it)."""
    code = ("import sys, threading, importlib, mxnet_tpu_torch as mt\n"
            "n = threading.active_count()\n"
            "importlib.import_module('mxnet_tpu_torch.%s')\n"
            "import torch.distributed as d\n"
            "assert mt.checkpoint.FORMAT and mt.parallel.dist.TIMEOUT_S\n"
            "assert not (d.is_available() and d.is_initialized())\n"
            "assert threading.active_count() == n\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in %r + ('triton',))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n" % (name, FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
