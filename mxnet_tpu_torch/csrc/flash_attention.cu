// Flash attention forward for Hopper (sm_90a): O = softmax(Q*K^T*scale)*V
// over (B, H, T, D) self-attention, causal optional, and the per-row
// log-sum-exp lse = m + log(l) that a blocked backward reads.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py::_fwd_kernel
// (launched by _flash_fwd_impl).  Same contract: q, k, v of one dtype
// (float32 or bfloat16), O in that dtype, lse float32 (B, H, T, 1); q is
// scaled in float32 BEFORE the product, scores and the online-softmax state
// are float32, masked scores are -1e30 (never -inf, so that a masked score
// minus the running maximum is never (-inf) - (-inf)), O = acc / max(l,
// 1e-30).  T is a multiple of 128, D a multiple of 8 up to 256
// (flash_available).
//
// Design.  The TPU kernel keeps one head's whole K and V in VMEM and runs
// the 128-row Q tiles as a sequential grid.  A Hopper block has at most
// 227 KB of shared memory, so here one block owns one (b*h, 64-row Q tile)
// and streams K and V through shared memory in 64-row tiles:
//   - the Q tile is loaded once, converted to float32 and scaled;
//   - per K/V tile, each of the 256 threads (16 x 16) computes a 4 x 4
//     block of S = Q*K^T (rows ty + 16i, columns tx + 16j) with FFMA from
//     shared memory; row and column reads are bank-conflict free (the Q/K
//     row stride D + 1 is odd);
//   - the causal mask is applied to S, the row maximum and row sum are
//     reduced across the 16 threads of a row with warp shuffles, the
//     running m, l and the accumulator are rescaled, and P goes to shared
//     memory;
//   - acc += P*V, each thread holding 4 rows x ceil(D/16) columns of the
//     float32 accumulator in registers (D is a template bucket: 32, 64, 128
//     or 256; columns past D are masked).
// Causal blocks skip the K tiles entirely above the diagonal (the TPU
// kernel's num_kb), and the grid launches the longest Q tiles first.
// q, k and v are read through their (b, h, t) strides with a unit last
// stride, so the strided views of a fused QKV projection need no copy.
//
// What bounds it.  At the LM's shapes (T = 1024, D = 64) attention does
// about 2*D = 128 multiply-adds per byte of q, k, v and o it must move, so
// on this card it is bound by arithmetic: the float32 CUDA-core rate for
// float32, the bfloat16 tensor-core rate for bfloat16.  This first kernel
// does all its arithmetic on the CUDA cores in float32 FFMA, fed from
// shared memory (about one shared load per two FFMA), with no overlap of
// the tile loads and the math.  Tensor cores (mma.sync / wgmma on bfloat16
// tiles, TF32 only where the caller allows it), TMA-fed double-buffered
// K/V tiles and P kept in registers are later work.
//
// Interface: plain C, loaded with ctypes.  flash_fwd_launch returns the
// cudaGetLastError() code of the launch (or of the shared-memory attribute
// call); the Python wrapper raises on it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // key rows per step
constexpr int NT = 256;   // threads per block, 16 x 16
constexpr int LDP = BK + 1;
constexpr float NEG_INF = -1e30f;
static_assert(BQ == BK, "the causal tile count assumes square tiles");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

size_t smem_bytes(int d) {
  return sizeof(float) *
         ((size_t)BQ * (d + 1) + (size_t)BK * (d + 1) + (size_t)BK * d +
          (size_t)BQ * LDP);
}

// NC: accumulator columns per thread (D <= 16 * NC)
template <typename T, int NC>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    long long qsb, long long qsh, long long qst, long long ksb,
    long long ksh, long long kst, long long vsb, long long vsh,
    long long vst, int H, int T_, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int ldq = D + 1;
  float* Qs = smem;                 // BQ x ldq, scaled
  float* Ks = Qs + BQ * ldq;        // BK x ldq
  float* Vs = Ks + BK * ldq;        // BK x D
  float* Ps = Vs + BK * D;          // BQ x LDP

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest causal tiles first
  const int q0 = qt * BQ;

  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;

  for (int r = ty; r < BQ; r += 16)
    for (int c = tx; c < D; c += 16)
      Qs[r * ldq + c] = to_f(qp[(long long)(q0 + r) * qst + c]) * scale;

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  const int nkb = causal ? qt + 1 : T_ / BK;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();   // the previous step is done with Ks, Vs and Ps
    for (int r = ty; r < BK; r += 16) {
      const long long row = k0 + r;
      for (int c = tx; c < D; c += 16) {
        Ks[r * ldq + c] = to_f(kp[row * kst + c]);
        Vs[r * D + c] = to_f(vp[row * vst + c]);
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (causal && k0 + tx + 16 * j > qpos) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mnew = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - mnew);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mnew);
        rs += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = mnew;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float vv = Vs[c * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = (long long)bh * T_ + q0 + ty + 16 * i;
    const float ll = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = tx + 16 * j;
      if (d < D) o[row * D + d] = from_f<T>(acc[i][j] / ll);
    }
    if (tx == 0) lse[row] = m[i] + logf(ll);
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const long long* st, int B, int H, int T_, int D, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)(T_ / BQ));
  flash_fwd_kernel<T, NC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], H, T_, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, const long long* st, int B, int H, int T_, int D,
             float scale, int causal, cudaStream_t s) {
  if (D <= 32) return launch<T, 2>(q, k, v, o, lse, st, B, H, T_, D, scale, causal, s);
  if (D <= 64) return launch<T, 4>(q, k, v, o, lse, st, B, H, T_, D, scale, causal, s);
  if (D <= 128) return launch<T, 8>(q, k, v, o, lse, st, B, H, T_, D, scale, causal, s);
  return launch<T, 16>(q, k, v, o, lse, st, B, H, T_, D, scale, causal, s);
}

}  // namespace

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, float* lse, long long qsb,
                                long long qsh, long long qst, long long ksb,
                                long long ksh, long long kst, long long vsb,
                                long long vsh, long long vst, int B, int H,
                                int T_, int D, float scale, int causal,
                                int bf16, void* stream) {
  if (D < 8 || D > 256 || D % 8 != 0 || T_ < BQ || T_ % BQ != 0 || B * H < 1)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, st, B, H, T_, D, scale,
                                   causal, s);
  return dispatch<float>(q, k, v, o, lse, st, B, H, T_, D, scale, causal, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
