"""Build and load the port's CUDA kernels.

Each kernel source, a file in ``mxnet_tpu_torch/csrc/`` or a source text
generated at run time (``rtc.Rtc``), is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at its first use, into
``.torch_kernels/`` beside the package, and loaded with ctypes.  The
library's file name carries a hash of the source text and the flags, so an
edited source or a changed flag builds anew and an unchanged one is reused,
by this process and by the next.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

from ..base import MXNetError

__all__ = ["CudaLibrary", "BUILD_DIR", "NVCC_FLAGS", "c_argtypes"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), ".torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise MXNetError("nvcc not found (PATH, $CUDA_HOME/bin or "
                         "/usr/local/cuda/bin): the CUDA kernels cannot be "
                         "built")
    return path


def c_argtypes(text, name):
    """The ctypes types of the parameters of ``extern "C"`` function
    ``name`` in the source text: c_void_p for a pointer, c_longlong,
    c_int and c_float for ``long long``, ``int`` and ``float``."""
    m = re.search(r'extern "C"[^(;]*\b%s\s*\(([^)]*)\)' % re.escape(name),
                  text)
    if m is None:
        raise MXNetError('no extern "C" function %s in the source' % name)
    types = []
    for param in m.group(1).split(","):
        words = param.replace("*", " * ").split()[:-1]   # drop the name
        if "*" in words:
            types.append(ctypes.c_void_p)
        elif words[-2:] == ["long", "long"]:
            types.append(ctypes.c_longlong)
        elif words[-1:] in (["int"], ["float"]):
            types.append(ctypes.c_int if words[-1] == "int"
                         else ctypes.c_float)
        else:
            raise MXNetError("%s: parameter type not known: %r"
                             % (name, param.strip()))
    return types


class CudaLibrary(object):
    """One kernel source and its loaded library.

    name   : the source's stem in ``csrc/`` (``norm_conv`` ->
             ``csrc/norm_conv.cu``), or the name of a generated source
    bind   : bind(lib) sets the argtypes/restype of the C functions
    text   : the source text, when it is generated rather than a file of
             ``csrc/``; it is written beside the library it builds
    """

    def __init__(self, name, bind, text=None):
        self.name = name
        self.text = text
        self.source = os.path.join(CSRC, name + ".cu") if text is None \
            else None
        self._bind = bind
        self.lib = None
        self.log = None
        self._lock = threading.Lock()

    def _source_bytes(self):
        if self.text is not None:
            return self.text.encode()
        with open(self.source, "rb") as f:
            return f.read()

    def so_path(self):
        """The library's file: ``.torch_kernels/<name>_<hash>.so``, the hash
        over the source text and the flags (the one cache rule)."""
        digest = hashlib.sha256(self._source_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return os.path.join(BUILD_DIR, "%s_%s.so" % (self.name, digest[:16]))

    def build(self):
        """Compile (once per source text and flags) and load the library.
        Returns the compiler's output of this process's build, or None when
        the library was already built."""
        with self._lock:
            if self.lib is not None:
                return self.log
            so = self.so_path()
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                src = self.source
                if src is None:
                    src = so[:-len(".so")] + ".cu"
                    with open(src, "wb") as f:
                        f.write(self._source_bytes())
                tmp = "%s.tmp-%d" % (so, os.getpid())
                res = subprocess.run(
                    [_nvcc()] + NVCC_FLAGS + ["-o", tmp, src],
                    capture_output=True, text=True)
                if res.returncode != 0:
                    raise MXNetError("nvcc failed on %s:\n%s%s"
                                     % (src, res.stdout, res.stderr))
                os.replace(tmp, so)
                self.log = res.stdout + res.stderr
            lib = ctypes.CDLL(so)
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            self._bind(lib)
            self.lib = lib
            return self.log

    def get(self):
        """The loaded library, built first if need be."""
        if self.lib is None:
            self.build()
        return self.lib

    def check(self, err, what):
        """Raise on a launch's nonzero cudaGetLastError() code."""
        if err != 0:
            raise MXNetError("%s kernel launch failed: %s"
                             % (what, self.lib.kernel_error_string(err)
                                .decode()))
