"""Runtime-compiled CUDA kernels on NDArrays (counterpart: mxnet_tpu/rtc.py,
whose ``Rtc._get`` wraps a Pallas body in ``pl.pallas_call``).

The port goes back to the contract of the reference MXNet's ``MXRtc``: the
kernel is CUDA C source of the kernel *body*, a string, and ``push`` honors
the CUDA grid and block it is given.  ``push`` generates

    extern "C" __global__ void <name>(const T0* <in0>, ..., T* <out0>, ...)

around the body, each ``T`` the C type of that NDArray's dtype, and beside
it an ``extern "C" int`` launcher that launches on the caller's current
torch CUDA stream and returns ``cudaGetLastError()``.  As in the reference
the signature carries only pointers: a kernel that needs a size has it
formatted into its source.  No pointer is ``__restrict__``: an NDArray may
be both an input and an output.  The result is compiled once per (source,
dtypes) with ``nvcc`` for ``sm_90a`` through ``kernel_build.CudaLibrary``
(cached on disk by a hash of the generated text and the flags), loaded with
ctypes and launched on the arrays' storage: outputs are written in place, so
an output that is a view writes through to its base.

A user's CUDA source has no plain version the port could run instead, so
``push`` on a CPU array raises, as do a missing ``nvcc`` and a compile error
(with ``nvcc``'s log).  ``launches`` counts pushes that launched a kernel,
``builds`` the ``nvcc`` runs of this process.

Example::

    rtc = mx.rtc.Rtc("axpb", ["x", "y"], ["out"], '''
        const long long n = %d;
        for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
             i < n; i += (long long)gridDim.x * blockDim.x)
          out[i] = x[i] * 2.0f + y[i];''' % x.size)
    rtc.push([x, y], [out], grid_dim_x=264, block_dim_x=256)
"""
from __future__ import annotations

import ctypes
import re
import threading

import torch

from .base import MXNetError
from .ops.kernel_build import CudaLibrary

__all__ = ["Rtc", "launches", "builds"]

# pushes that launched a kernel, and nvcc runs, since import (or since a
# caller reset them to 0)
launches = 0
builds = 0

_C_TYPES = {torch.float32: "float", torch.float64: "double",
            torch.float16: "__half", torch.bfloat16: "__nv_bfloat16",
            torch.int32: "int", torch.int64: "long long",
            torch.uint8: "unsigned char"}
_HEADERS = {"__half": "cuda_fp16.h", "__nv_bfloat16": "cuda_bf16.h"}
# CUDA's launch limits (every card since compute capability 3.0)
_MAX_BLOCK = (1024, 1024, 64)
_MAX_THREADS = 1024
_MAX_GRID = (2 ** 31 - 1, 65535, 65535)
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*\Z")
_build_lock = threading.Lock()


def _c_type(dtype):
    try:
        return _C_TYPES[dtype]
    except KeyError:
        raise MXNetError("Rtc: no C type for dtype %s (it takes %s)"
                         % (dtype, ", ".join(str(d) for d in _C_TYPES)))


def _dims(what, given, limits):
    for i, (d, lim) in enumerate(zip(given, limits)):
        if not 1 <= d <= lim:
            raise MXNetError("Rtc: %s dimension %s is %d, outside [1, %d]"
                             % (what, "xyz"[i], d, lim))
    return given


class Rtc(object):
    """A runtime-compiled CUDA kernel bound to named inputs and outputs
    (parity: MXRtc; mxnet_tpu.rtc.Rtc's signature).

    name : the kernel's name, a C identifier
    input_names / output_names : the names the body reads and writes
        (pointers to the arrays' first elements)
    kernel : CUDA C source of the kernel body, a string
    grid : the default grid, up to three ints (each missing one is 1)
    interpret : only None or False: CUDA source has no interpreter
    """

    def __init__(self, name, input_names, output_names, kernel, grid=None,
                 interpret=None):
        if callable(kernel):
            raise MXNetError(
                "Rtc %r: kernel is a Python callable (a Pallas body); the "
                "port's Rtc takes CUDA C source of the kernel body, a "
                "string, as the reference MXNet's MXRtc did" % (name,))
        if not isinstance(kernel, str):
            raise MXNetError("Rtc %r: kernel must be CUDA C source, a "
                             "string" % (name,))
        if interpret:
            raise MXNetError("Rtc %r: interpret=True: CUDA source has no "
                             "interpreter; push runs it on the card" % (name,))
        names = [name] + list(input_names) + list(output_names)
        bad = [n for n in names if not _IDENT.match(str(n))]
        if bad:
            raise MXNetError("Rtc: %s must be C identifiers" % bad)
        if len(set(names)) != len(names):
            raise MXNetError("Rtc %r: the kernel, input and output names must "
                             "differ" % (name,))
        grid = tuple(int(g) for g in (grid or ()))
        if len(grid) > 3:
            raise MXNetError("Rtc %r: grid has at most three dimensions"
                             % (name,))
        self.name = name
        self.input_names = list(input_names)
        self.output_names = list(output_names)
        self.kernel = kernel
        self.grid = grid
        self._libs = {}

    def source(self, in_dtypes, out_dtypes):
        """The CUDA C text ``push`` compiles for these input and output
        dtypes: the kernel around the user's body, its launcher
        ``<name>_launch`` and ``kernel_error_string``."""
        name = self.name
        in_t = [_c_type(d) for d in in_dtypes]
        out_t = [_c_type(d) for d in out_dtypes]
        params = ["const %s* %s" % (t, n)
                  for t, n in zip(in_t, self.input_names)] \
            + ["%s* %s" % (t, n) for t, n in zip(out_t, self.output_names)]
        casts = ["(const %s*)a%d" % (t, i) for i, t in enumerate(in_t)] \
            + ["(%s*)a%d" % (t, len(in_t) + i) for i, t in enumerate(out_t)]
        ptrs = ["const void* a%d" % i for i in range(len(in_t))] \
            + ["void* a%d" % (len(in_t) + i) for i in range(len(out_t))] \
            + ["unsigned int %s" % d
               for d in ("gx", "gy", "gz", "bx", "by", "bz")]
        heads = sorted({_HEADERS[t] for t in in_t + out_t if t in _HEADERS})
        return "\n".join(
            ["// generated by mxnet_tpu_torch.rtc for the kernel %s" % name,
             "#include <cuda_runtime.h>"]
            + ["#include <%s>" % h for h in heads]
            + ['extern "C" __global__ void %s(%s) {'
               % (name, ", ".join(params)),
               self.kernel,
               "}",
               "",
               'extern "C" int %s_launch(%s, void* stream) {'
               % (name, ", ".join(ptrs)),
               "  %s<<<dim3(gx, gy, gz), dim3(bx, by, bz), 0, "
               "(cudaStream_t)stream>>>(%s);" % (name, ", ".join(casts)),
               "  return (int)cudaGetLastError();",
               "}",
               "",
               'extern "C" const char* kernel_error_string(int code) {',
               "  return cudaGetErrorString((cudaError_t)code);",
               "}",
               ""])

    def _library(self, in_dtypes, out_dtypes):
        """The ``CudaLibrary`` of these dtypes, built (with ``nvcc`` unless
        ``.torch_kernels/`` has it) and loaded."""
        global builds
        key = (tuple(in_dtypes), tuple(out_dtypes))
        lib = self._libs.get(key)
        if lib is None:
            launcher = self.name + "_launch"
            n_ptr = len(self.input_names) + len(self.output_names)

            def bind(so):
                fn = getattr(so, launcher)
                fn.argtypes = [ctypes.c_void_p] * n_ptr \
                    + [ctypes.c_uint] * 6 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib = CudaLibrary("rtc_" + self.name, bind,
                              text=self.source(*key))
            with _build_lock:
                if lib.build() is not None:
                    builds += 1
            self._libs[key] = lib
        return lib

    def _geometry(self, grid_dims, block_dims):
        grid = tuple(g if g is not None else
                     (self.grid[i] if i < len(self.grid) else 1)
                     for i, g in enumerate(grid_dims))
        block = tuple(1 if b is None else b for b in block_dims)
        grid = _dims("grid", tuple(int(g) for g in grid), _MAX_GRID)
        block = _dims("block", tuple(int(b) for b in block), _MAX_BLOCK)
        if block[0] * block[1] * block[2] > _MAX_THREADS:
            raise MXNetError("Rtc: a block of %s is %d threads, more than %d"
                             % (block, block[0] * block[1] * block[2],
                                _MAX_THREADS))
        return grid, block

    def push(self, ins, outs, grid_dim_x=None, grid_dim_y=None,
             grid_dim_z=None, block_dim_x=None, block_dim_y=None,
             block_dim_z=None):
        """Launch the kernel on ``ins`` and ``outs`` (parity: MXRtcPush):
        the grid from ``grid_dim_*``, else the constructor's ``grid``, else
        1; the block from ``block_dim_*``, else 1.  The outputs are written
        in place.  Returns ``outs``."""
        global launches
        if len(ins) != len(self.input_names):
            raise MXNetError("%s expects %d inputs, got %d"
                             % (self.name, len(self.input_names), len(ins)))
        if len(outs) != len(self.output_names):
            raise MXNetError("%s expects %d outputs, got %d"
                             % (self.name, len(self.output_names),
                                len(outs)))
        grid, block = self._geometry((grid_dim_x, grid_dim_y, grid_dim_z),
                                     (block_dim_x, block_dim_y, block_dim_z))
        tensors = [a.value for a in list(ins) + list(outs)]
        for n, t in zip(self.input_names + self.output_names, tensors):
            if not t.is_contiguous():
                raise MXNetError("Rtc %s: %s is not contiguous (push does "
                                 "not copy it)" % (self.name, n))
        devs = {t.device for t in tensors}
        if any(d.type != "cuda" for d in devs):
            raise MXNetError("Rtc %s: kernels run on the card; got arrays on "
                             "%s (a user's CUDA source has no CPU version)"
                             % (self.name, sorted(str(d) for d in devs)))
        if len(devs) > 1:
            raise MXNetError("Rtc %s: every array must be on one card, got %s"
                             % (self.name, sorted(str(d) for d in devs)))
        lib = self._library([t.dtype for t in tensors[:len(ins)]],
                           [t.dtype for t in tensors[len(ins):]])
        dev = tensors[0].device
        fn = getattr(lib.lib, self.name + "_launch")
        with torch.cuda.device(dev):
            err = fn(*[t.data_ptr() for t in tensors], *grid, *block,
                     torch.cuda.current_stream(dev).cuda_stream)
        lib.check(err, "Rtc %s" % self.name)
        launches += 1
        return outs
