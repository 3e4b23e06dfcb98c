// NormConv for Hopper (sm_90a): y = conv(relu(x*scale + shift), w), with
// optional float32 per-output-channel sum and sum of squares of y.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_conv.py::_nc_kernel (launched
// by _nc_pallas_fwd).  Same contract: x NHWC (N, H, W, Cin), w HWIO
// (K, K, Cin, Cout), K in {1, 3} (any K works here), stride 1/2, pad 0/1,
// y NHWC in x's dtype (float32 or bfloat16), float32 accumulation, and the
// statistics taken from the float32 accumulator before the downcast.
//
// Design.  The TPU kernel keeps one whole image in VMEM and runs the taps as
// a sequential grid; Hopper has 227 KB of shared memory per block and runs
// blocks in no order, so this is an implicit GEMM instead:
//   M = N*OH*OW rows (output pixels), Ncol = Cout, Kdim = K*K*Cin.
// Each block owns a 64 x 64 tile of (M, Cout) and walks Kdim in chunks of
// 16 input channels of one tap.  The A-tile load applies the prologue
// (scale, shift, ReLU) while it copies the input into shared memory, so the
// BatchNorm "apply" never reaches device memory; taps that fall in the
// padding load 0 AFTER the prologue (the TPU kernel pads relu(x*s+t), not
// x).  256 threads each hold a 4 x 4 float32 sub-tile of the accumulator.
//
// Rounding.  The prologue rounds exactly as the plain PyTorch version does:
// scale and shift are cast to x's dtype by the caller, x*scale and +shift
// are two separately rounded operations (no fused multiply-add), and for
// bfloat16 each result is rounded to bfloat16.  The prologue output is thus
// bit-identical to the plain version's; only the order of the float32 sums
// of the convolution differs.
//
// Statistics.  Blocks cannot carry a sum from one to the next as the TPU
// grid did, so each block reduces its tile's valid rows (rows past M in a
// ragged tile are masked) into shared memory, then adds one partial per
// channel into a zeroed float32 (Cout,) buffer with atomicAdd.
//
// What bounds it.  At ResNet-50 shapes the convolution has 64-4608 MACs per
// input element, far above the card's ~20 FLOP/byte float32 (CUDA core)
// ridge, so the bound is arithmetic.  This first kernel runs its MACs on the
// CUDA cores in float32 (FFMA) from shared memory: the tensor cores (wgmma,
// with TMA-fed pipelined tiles) are the step that would lift it toward the
// bfloat16 tensor-core rate, and are later work.  Both dtypes accumulate in
// float32 on the CUDA cores.
//
// Interface: plain C, loaded with ctypes.  nc_launch returns the
// cudaGetLastError() code of the launch; the Python wrapper raises on it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 64;    // output pixels per block
constexpr int BN = 64;    // output channels per block
constexpr int BK = 16;    // input channels per step
constexpr int NT = 256;   // threads per block
constexpr int APAD = 4;   // keeps the A-tile stores off one bank

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// relu keeps NaN, like the plain version's relu
__device__ __forceinline__ float relu_f(float v) { return v < 0.f ? 0.f : v; }

// x*scale + shift in x's dtype, each operation rounded on its own
__device__ __forceinline__ float apply(float x, float s, float t, int relu) {
  float v = __fadd_rn(__fmul_rn(x, s), t);
  return relu ? relu_f(v) : v;
}
__device__ __forceinline__ float apply(__nv_bfloat16 x, __nv_bfloat16 s,
                                       __nv_bfloat16 t, int relu) {
  float p = to_f(__float2bfloat16_rn(__fmul_rn(to_f(x), to_f(s))));
  float v = to_f(__float2bfloat16_rn(__fadd_rn(p, to_f(t))));
  return relu ? relu_f(v) : v;
}

template <typename T>
__global__ void __launch_bounds__(NT)
nc_kernel(const T* __restrict__ x, const T* __restrict__ w,
          const T* __restrict__ scale, const T* __restrict__ shift,
          T* __restrict__ y, float* __restrict__ ysum,
          float* __restrict__ ysq, int n, int h, int wd, int cin, int cout,
          int k, int stride, int pad, int oh, int ow, int relu, int prologue,
          int stats) {
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float red[2][BN];

  const int tid = threadIdx.x;
  const long long M = (long long)n * oh * ow;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A-tile loads: channel ac of rows ar, ar+16, ar+32, ar+48 (consecutive
  // threads read consecutive channels of one pixel: NHWC is channel-minor)
  const int ac = tid % BK;
  const int ar = tid / BK;
  int ih0[4], iw0[4];
  long long abase[4];
  bool aok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ar + 16 * i;
    aok[i] = m < M;
    const long long mm = aok[i] ? m : 0;
    const long long img = mm / ((long long)oh * ow);
    const int rem = (int)(mm - img * oh * ow);
    ih0[i] = (rem / ow) * stride - pad;
    iw0[i] = (rem % ow) * stride - pad;
    abase[i] = img * h * wd * cin;
  }
  // B-tile loads: output channel bn of input-channel rows bk, bk+4, ...
  const int bn = tid % BN;
  const int bk = tid / BN;
  // compute: rows ty*4.., columns tx*4..
  const int tx = tid % 16;
  const int ty = tid / 16;

  if (stats && tid < BN) {
    red[0][tid] = 0.f;
    red[1][tid] = 0.f;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kh = 0; kh < k; ++kh) {
    for (int kw = 0; kw < k; ++kw) {
      const T* wtap = w + (long long)(kh * k + kw) * cin * cout;
      for (int c0 = 0; c0 < cin; c0 += BK) {
        const int c = c0 + ac;
        T sc = T(), sh = T();
        if (prologue && c < cin) {
          sc = scale[c];
          sh = shift[c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ih = ih0[i] + kh;
          const int iw = iw0[i] + kw;
          float v = 0.f;
          if (aok[i] && c < cin && ih >= 0 && ih < h && iw >= 0 && iw < wd) {
            const T xv = x[abase[i] + ((long long)ih * wd + iw) * cin + c];
            v = prologue ? apply(xv, sc, sh, relu) : to_f(xv);
          }
          As[ac][ar + 16 * i] = v;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = bk + 4 * i;
          const int cc = c0 + kk;
          const int co = n0 + bn;
          Bs[kk][bn] = (cc < cin && co < cout)
                           ? to_f(wtap[(long long)cc * cout + co])
                           : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
          const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co < cout) y[m * cout + co] = from_f<T>(acc[i][j]);
    }
  }

  if (stats) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (m0 + ty * 4 + i < M) {   // masked rows never enter the sums
          s += acc[i][j];
          q += acc[i][j] * acc[i][j];
        }
      }
      atomicAdd(&red[0][tx * 4 + j], s);
      atomicAdd(&red[1][tx * 4 + j], q);
    }
    __syncthreads();
    if (tid < BN && n0 + tid < cout) {
      atomicAdd(&ysum[n0 + tid], red[0][tid]);
      atomicAdd(&ysq[n0 + tid], red[1][tid]);
    }
  }
}

}  // namespace

extern "C" int nc_launch(const void* x, const void* w, const void* scale,
                         const void* shift, void* y, float* ysum, float* ysq,
                         int n, int h, int wd, int cin, int cout, int k,
                         int stride, int pad, int oh, int ow, int relu,
                         int prologue, int stats, int bf16, void* stream) {
  const long long M = (long long)n * oh * ow;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((cout + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    nc_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(scale),
        static_cast<const __nv_bfloat16*>(shift),
        static_cast<__nv_bfloat16*>(y), ysum, ysq, n, h, wd, cin, cout, k,
        stride, pad, oh, ow, relu, prologue, stats);
  } else {
    nc_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(shift),
        static_cast<float*>(y), ysum, ysq, n, h, wd, cin, cout, k, stride,
        pad, oh, ow, relu, prologue, stats);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
