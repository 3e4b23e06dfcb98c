"""Build and load the port's CUDA kernels and its native C API library.

Each kernel source, a file in ``mxnet_tpu_torch/csrc/`` or a source text
generated at run time (``rtc.Rtc``), is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at its first use, into
``.torch_kernels/`` beside the package, and loaded with ctypes.  The
library's file name carries a hash of the source text and the flags, so an
edited source or a changed flag builds anew and an unchanged one is reused,
by this process and by the next.

``HostLibrary`` does the same with ``g++`` for the C API bridge
(``csrc/c_api.cc``, which embeds this interpreter's libpython), and builds
the cpp-package's ``op.h`` generator and examples against it.  Every output
is written under a temporary name and renamed into place, so that several
processes may build at once.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import threading

from ..base import MXNetError

__all__ = ["CudaLibrary", "HostLibrary", "BUILD_DIR", "NVCC_FLAGS",
           "HOST_FLAGS", "c_argtypes", "python_build_flags"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(_PKG)
CSRC = os.path.join(_PKG, "csrc")
INCLUDE = os.path.join(_PKG, "include")
CPP_PACKAGE = os.path.join(ROOT, "cpp-package")
BUILD_DIR = os.path.join(ROOT, ".torch_kernels")
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
    c_int, c_float and c_double for ``long long``, ``int``, ``float`` and
    ``double``."""
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
        elif words[-1:] in (["int"], ["float"], ["double"]):
            types.append({"int": ctypes.c_int, "float": ctypes.c_float,
                          "double": ctypes.c_double}[words[-1]])
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
    flags  : nvcc flags of this source, after ``NVCC_FLAGS``
    """

    def __init__(self, name, bind, text=None, flags=()):
        self.name = name
        self.text = text
        self.flags = list(flags)
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
        digest = hashlib.sha256(
            self._source_bytes()
            + " ".join(NVCC_FLAGS + self.flags).encode()).hexdigest()
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
                    [_nvcc()] + NVCC_FLAGS + self.flags + ["-o", tmp, src],
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


HOST_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC", "-fvisibility=hidden"]


def python_build_flags():
    """(include directory, link flags) that embed this interpreter: the
    ``python3-config --includes`` / ``--ldflags --embed`` of ``sysconfig``,
    with the library directory as the run path.  Raises when the
    interpreter ships no ``Python.h`` or no shared libpython."""
    inc = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise MXNetError("no Python.h in %s: the C API library cannot be "
                         "built for this interpreter" % inc)
    cfg = sysconfig.get_config_var
    if not cfg("Py_ENABLE_SHARED"):
        raise MXNetError("this interpreter has no shared libpython "
                         "(Py_ENABLE_SHARED=0): the C API library cannot "
                         "embed it")
    libdir = cfg("LIBDIR")
    ldflags = ["-L" + libdir,
               "-lpython%s%s" % (cfg("VERSION"), cfg("ABIFLAGS") or "")]
    ldflags += (cfg("LIBS") or "").split() + (cfg("SYSLIBS") or "").split()
    return inc, ldflags + ["-Wl,-rpath," + libdir]


def _digest(paths, extra):
    h = hashlib.sha256()
    for path in paths:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(extra).encode())
    return h.hexdigest()[:16]


def _compile(cmd, out):
    """Run the compiler command ``cmd``, which writes ``out``, into a
    temporary name, then rename that into place; raise with the
    compiler's output when it fails."""
    tmp = "%s.tmp-%d-%d" % (out, os.getpid(), threading.get_ident())
    cmd = [tmp if a == out else a for a in cmd]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise MXNetError("cannot run %s: %s" % (cmd[0], exc))
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise MXNetError("%s failed (exit %d):\n%s\n%s%s"
                         % (cmd[0], res.returncode, " ".join(cmd),
                            res.stdout, res.stderr))
    os.replace(tmp, out)
    return res.stdout + res.stderr


class HostLibrary(object):
    """The port's C API library (``csrc/c_api.cc`` with the headers of
    ``include/``), built by ``g++`` at its first use into
    ``.torch_kernels/libmxnet_tpu_torch_<hash>.so`` (the hash over the
    sources, the headers and the flags), and what the cpp-package builds
    against it.

    build()         compile the library; the compiler's output, or None
                    when it was built already
    get()           the library loaded with ctypes (RTLD_LOCAL), after
                    ``MXTPULibInit``
    op_h()          the directory holding the generated ``mxnet-cpp/op.h``
                    (``cpp-package/src/op_h_generator.cc`` built against
                    the library and run)
    example(name)   the binary of ``cpp-package/example/<name>.cpp``
    run_env()       the environment a binary of the library runs in: the
                    repository's root and this interpreter's path on
                    PYTHONPATH
    A failed build raises ``MXNetError`` with the compiler's output.
    """

    def __init__(self, cxx=None):
        self.cxx = cxx or os.environ.get("CXX") or "g++"
        self.source = os.path.join(CSRC, "c_api.cc")
        self.lib = None
        self.log = None
        self._lock = threading.Lock()

    def so_path(self):
        inc, ldflags = python_build_flags()
        headers = sorted(glob.glob(os.path.join(INCLUDE, "mxnet_tpu",
                                                "*.h")))
        tag = _digest([self.source] + headers,
                      [self.cxx] + HOST_FLAGS + [inc] + ldflags)
        return os.path.join(BUILD_DIR, "libmxnet_tpu_torch_%s.so" % tag)

    def build(self):
        with self._lock:
            so = self.so_path()
            if os.path.exists(so):
                return None
            os.makedirs(BUILD_DIR, exist_ok=True)
            inc, ldflags = python_build_flags()
            self.log = _compile(
                [self.cxx] + HOST_FLAGS
                + ["-I" + INCLUDE, "-I" + inc, self.source, "-o", so,
                   "-Wl,-soname," + os.path.basename(so)] + ldflags, so)
            return self.log

    def get(self):
        if self.lib is None:
            self.build()
            lib = ctypes.CDLL(self.so_path())
            lib.MXGetLastError.restype = ctypes.c_char_p
            if lib.MXTPULibInit() != 0:
                raise MXNetError("MXTPULibInit failed: %s"
                                 % lib.MXGetLastError().decode())
            self.lib = lib
        return self.lib

    def run_env(self, env=None):
        env = dict(os.environ if env is None else env)
        path = [ROOT] + [p for p in sys.path if p and os.path.isdir(p)]
        env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(path))
        return env

    def _binary(self, name, source, includes, extra_digest=()):
        """Build ``source`` into an executable linked against the
        library; returns its path."""
        so = self.so_path()
        self.build()
        tag = _digest([source, so] + list(extra_digest),
                      [self.cxx] + includes)
        out = os.path.join(BUILD_DIR, "%s_%s" % (name, tag))
        if not os.path.exists(out):
            _compile([self.cxx, "-std=c++17", "-O2"]
                     + ["-I" + d for d in includes]
                     + [source, "-o", out, so, "-Wl,-rpath," + BUILD_DIR]
                     + python_build_flags()[1], out)
        return out

    def op_h(self):
        """Generate ``mxnet-cpp/op.h`` from the operator registry through
        the library's reflection calls (once for the library, the
        generator and the ops' sources); returns the directory to put on
        the include path."""
        gen_src = os.path.join(CPP_PACKAGE, "src", "op_h_generator.cc")
        ops = sorted(glob.glob(os.path.join(_PKG, "ops", "*.py")))
        gen = self._binary("op_h_generator", gen_src, [INCLUDE])
        tag = _digest([gen] + ops + [os.path.join(_PKG, "capi.py")], [])
        out_dir = os.path.join(BUILD_DIR, "op_h_%s" % tag)
        header = os.path.join(out_dir, "mxnet-cpp", "op.h")
        if not os.path.exists(header):
            os.makedirs(os.path.dirname(header), exist_ok=True)
            tmp = "%s.tmp-%d-%d" % (header, os.getpid(),
                                    threading.get_ident())
            res = subprocess.run([gen, tmp], capture_output=True, text=True,
                                 env=self.run_env(), timeout=600)
            if res.returncode != 0:
                raise MXNetError("op_h_generator failed (exit %d):\n%s%s"
                                 % (res.returncode, res.stdout, res.stderr))
            os.replace(tmp, header)
        return out_dir

    def example(self, name):
        """Build ``cpp-package/example/<name>.cpp`` against the library
        and the generated ``op.h``; returns the binary's path."""
        gen_dir = self.op_h()
        src = os.path.join(CPP_PACKAGE, "example", name + ".cpp")
        cpp_inc = os.path.join(CPP_PACKAGE, "include")
        headers = glob.glob(os.path.join(cpp_inc, "mxnet-cpp", "*.h"))
        return self._binary(name, src, [INCLUDE, cpp_inc, gen_dir],
                            sorted(headers)
                            + [os.path.join(gen_dir, "mxnet-cpp", "op.h")])
