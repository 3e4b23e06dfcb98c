// Flash attention backward for Hopper (sm_90a): two kernels that recompute
// the attention probabilities from the forward's saved log-sum-exp and
// return dQ, dK and dV over (B, H, T, D) self-attention, causal optional.
//
// Replaces the TPU kernels mxnet_tpu/ops/pallas_kernels.py::_dq_kernel and
// ::_dkv_kernel (both launched by _flash_bwd).  Same contract: q, k, v and
// dO of one dtype (float32 or bfloat16), lse and delta = rowsum(dO * O)
// float32 (B, H, T, 1) (delta is computed by the caller, as in the JAX
// package, where XLA computes it outside the kernels); all arithmetic in
// float32; dq, dk, dv in the input dtype.  Per (query, key) pair:
//   s  = (q . k) * scale          (scale applied AFTER the product, as the
//                                   TPU backward does; the forward scales q
//                                   first: the two differ by one rounding)
//   s  = -1e30 where causal masks it, so p = exp(-1e30 - lse) = 0, never NaN
//   p  = exp(s - lse)
//   dp = dO . v
//   ds = p * (dp - delta) * scale
//   dQ = sum_k ds * k,  dK = sum_q ds * q,  dV = sum_q p * dO.
// T is a multiple of 128, D a multiple of 8 up to 256 (flash_available).
//
// Design.  The TPU kernels keep a whole head's K/V (dQ) or Q/dO (dK/dV) in
// VMEM and walk the other operand as a sequential grid.  A Hopper block has
// at most 227 KB of shared memory and blocks run in parallel, in no order,
// so here:
//   - dQ kernel: one block owns one (b*h, Q tile).  Q, dO, lse and delta are
//     loaded once (float32 in shared memory); K and V tiles stream through
//     shared memory.  Per K tile each of the 256 threads (16 x 16) computes
//     an R x R block of S = Q.K^T and dP = dO.V^T (rows ty + 16i, columns
//     tx + 16j), forms dS into shared memory, and then adds dS.K to its R x
//     ceil(D/16) float32 accumulator of dQ held in registers.  Causal
//     blocks stop at the diagonal K tile; the grid issues the longest Q
//     tiles first.
//   - dK/dV kernel: one block owns one (b*h, K/V tile).  K and V are loaded
//     once; Q, dO, lse and delta tiles stream.  Per Q tile the block forms P
//     and dS (as above) into shared memory, then adds P^T.dO and dS^T.Q to
//     two float32 register accumulators (dV and dK).  Causal blocks start
//     at the diagonal Q tile ((j * BK) / BQ with BQ == BK here), and the
//     grid issues the longest K tiles (the first ones) first.
//   - Each output tile belongs to exactly one block and every sum is taken
//     in a fixed order: no atomics, so the backward is bitwise repeatable.
//   - Tiles are 64 rows (R = 4) up to D = 128 and 32 rows (R = 2) for
//     D <= 256, so that shared memory (float32 Q, dO, K, V tiles with an
//     odd row stride D + 1, which keeps row and column reads free of bank
//     conflicts, plus the P/dS tiles) stays under 227 KB: 84 KB (dQ) and
//     100 KB (dK/dV) at D = 64, 149/166 KB at D = 128, 136/140 KB at D = 256;
//     and the two dK/dV accumulators stay at 2 x R x ceil(D/16) <= 64
//     registers a thread.
//   q, k, v and dO are read through their (b, h, t) strides with a unit last
//   stride, so the strided views of the LM's fused QKV projection and the
//   permuted gradient of its attention-output transpose need no copy.
//
// What bounds it.  Per unmasked (q, k) pair the dQ kernel does 3 products of
// length D (q.k, dO.v, ds.k) and the dK/dV kernel 4 (q.k, dO.v, p.dO, ds.q):
// at the LM's shapes (T = 1024, D = 64) far more operations than bytes, so
// both are bound by arithmetic on this card.  These first kernels do it all
// on the CUDA cores in float32 FFMA fed from shared memory, with no overlap
// of tile loads and math; tensor cores (mma.sync / wgmma on bfloat16 tiles),
// TMA-fed double-buffered tiles and delta folded into a kernel are later
// work.
//
// Interface: plain C, loaded with ctypes.  Each *_launch returns the
// cudaGetLastError() code of the launch (or of the shared-memory attribute
// call); the Python wrapper raises on it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NT = 256;   // threads per block, 16 x 16
constexpr float NEG_INF = -1e30f;

// MIN_BLOCKS: the blocks per SM that a bucket's shared memory allows,
// given to the compiler as __launch_bounds__' minimum so that registers
// never halve it: two up to D = 64 (84 KB for dQ, 100 KB for dK/dV), one
// above.  With the minimum left at one, ptxas gave the D = 64 dK/dV kernel
// 143 registers a thread, so only one 256-thread block fitted an SM.
#define MIN_BLOCKS ((R == 4 && NC <= 4) ? 2 : 1)

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

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, gb, gh, gt;
};

// rows of `BT` starting at row0 of one (b, h) slice into shared memory as
// float32, row stride ld
template <typename T, int BT>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int row0, int D,
                                          int ld, int tx, int ty) {
  for (int r = ty; r < BT; r += 16) {
    const T* row = src + (long long)(row0 + r) * st;
    for (int c = tx; c < D; c += 16) dst[r * ld + c] = to_f(row[c]);
  }
}

// S = A.B^T and dP = G.V^T over D for one R x R block per thread:
// rows ty + 16i of A/G, rows tx + 16j of B/V
template <int R>
__device__ __forceinline__ void two_products(
    const float* A, const float* Bm, const float* G, const float* V, int D,
    int ld, int tx, int ty, float (&s)[R][R], float (&dp)[R][R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[R], gv[R], bv[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      av[i] = A[(ty + 16 * i) * ld + d];
      gv[i] = G[(ty + 16 * i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      bv[j] = Bm[(tx + 16 * j) * ld + d];
      vv[j] = V[(tx + 16 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
}

size_t dq_smem_bytes(int d, int bt) {
  return sizeof(float) * ((size_t)4 * bt * (d + 1) + (size_t)bt * (bt + 1) +
                          2 * (size_t)bt);
}

size_t dkv_smem_bytes(int d, int bt) {
  return sizeof(float) * ((size_t)4 * bt * (d + 1) +
                          2 * (size_t)bt * (bt + 1) + 2 * (size_t)bt);
}

// NC: accumulator columns per thread (D <= 16 * NC); R: rows per thread,
// tiles of BT = 16 * R rows
template <typename T, int NC, int R>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, Strides st, int H, int T_, int D, float scale,
    int causal) {
  constexpr int BT = 16 * R;
  constexpr int LDS = BT + 1;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;               // BT x ld
  float* Gs = Qs + BT * ld;       // dO, BT x ld
  float* Ks = Gs + BT * ld;       // BT x ld
  float* Vs = Ks + BT * ld;       // BT x ld
  float* Ss = Vs + BT * ld;       // dS, BT x LDS
  float* Ls = Ss + BT * LDS;      // lse, BT
  float* Es = Ls + BT;            // delta, BT

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest causal tiles first
  const int q0 = qt * BT;

  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;
  load_tile<T, BT>(Qs, q + b * st.qb + h * st.qh, st.qt, q0, D, ld, tx, ty);
  load_tile<T, BT>(Gs, g + b * st.gb + h * st.gh, st.gt, q0, D, ld, tx, ty);
  for (int r = tid; r < BT; r += NT) {
    Ls[r] = lse[(long long)bh * T_ + q0 + r];
    Es[r] = delta[(long long)bh * T_ + q0 + r];
  }

  float acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  const int nkb = causal ? qt + 1 : T_ / BT;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BT;
    __syncthreads();   // the previous step is done with Ks, Vs and Ss
    load_tile<T, BT>(Ks, kp, st.kt, k0, D, ld, tx, ty);
    load_tile<T, BT>(Vs, vp, st.vt, k0, D, ld, tx, ty);
    __syncthreads();

    float s[R][R], dp[R][R];
    two_products<R>(Qs, Ks, Gs, Vs, D, ld, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = ty + 16 * i;
      const float l = Ls[row], e = Es[row];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && k0 + col > q0 + row) x = NEG_INF;
        const float p = expf(x - l);
        Ss[row * LDS + col] = p * (dp[i][j] - e) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float ds[R];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = Ss[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float kk = Ks[c * ld + d];
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i][j] = fmaf(ds[i], kk, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long row = (long long)bh * T_ + q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dq[row * D + d] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, int NC, int R>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, Strides st, int H, int T_, int D,
    float scale, int causal) {
  constexpr int BT = 16 * R;
  constexpr int LDS = BT + 1;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Ks = smem;               // BT x ld
  float* Vs = Ks + BT * ld;       // BT x ld
  float* Qs = Vs + BT * ld;       // BT x ld
  float* Gs = Qs + BT * ld;       // dO, BT x ld
  float* Ps = Gs + BT * ld;       // P, BT (q) x LDS (k)
  float* Ds = Ps + BT * LDS;      // dS, BT (q) x LDS (k)
  float* Ls = Ds + BT * LDS;      // lse, BT
  float* Es = Ls + BT;            // delta, BT

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int kt = blockIdx.y;      // causal: the first K tiles are longest
  const int k0 = kt * BT;

  const T* qp = q + b * st.qb + h * st.qh;
  const T* gp = g + b * st.gb + h * st.gh;
  load_tile<T, BT>(Ks, k + b * st.kb + h * st.kh, st.kt, k0, D, ld, tx, ty);
  load_tile<T, BT>(Vs, v + b * st.vb + h * st.vh, st.vt, k0, D, ld, tx, ty);

  float adk[R][NC], adv[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      adk[i][j] = 0.f;
      adv[i][j] = 0.f;
    }

  // the TPU kernel's start_qb = (j * block_k) // block_q, which is kt here
  // (BQ == BK)
  const int qb0 = causal ? kt : 0;
  for (int qb = qb0; qb < T_ / BT; ++qb) {
    const int q0 = qb * BT;
    __syncthreads();   // the previous step is done with Qs, Gs, Ps and Ds
    load_tile<T, BT>(Qs, qp, st.qt, q0, D, ld, tx, ty);
    load_tile<T, BT>(Gs, gp, st.gt, q0, D, ld, tx, ty);
    for (int r = tid; r < BT; r += NT) {
      Ls[r] = lse[(long long)bh * T_ + q0 + r];
      Es[r] = delta[(long long)bh * T_ + q0 + r];
    }
    __syncthreads();

    // rows: queries ty + 16i; columns: keys tx + 16j
    float s[R][R], dp[R][R];
    two_products<R>(Qs, Ks, Gs, Vs, D, ld, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = ty + 16 * i;
      const float l = Ls[row], e = Es[row];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && k0 + col > q0 + row) x = NEG_INF;
        const float p = expf(x - l);
        Ps[row * LDS + col] = p;
        Ds[row * LDS + col] = p * (dp[i][j] - e) * scale;
      }
    }
    __syncthreads();

    // this thread's keys ty + 16i, head columns tx + 16j
#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float pk[R], dsk[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pk[i] = Ps[c * LDS + ty + 16 * i];
        dsk[i] = Ds[c * LDS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float gg = Gs[c * ld + d];
          const float qq = Qs[c * ld + d];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            adv[i][j] = fmaf(pk[i], gg, adv[i][j]);
            adk[i][j] = fmaf(dsk[i], qq, adk[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long row = (long long)bh * T_ + k0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dk[row * D + d] = from_f<T>(adk[i][j]);
        dv[row * D + d] = from_f<T>(adv[i][j]);
      }
    }
  }
}

template <typename T, int NC, int R>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const float* lse, const float* delta, void* dq,
              const Strides& st, int B, int H, int T_, int D, float scale,
              int causal, cudaStream_t stream) {
  constexpr int BT = 16 * R;
  const size_t smem = dq_smem_bytes(D, BT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, NC, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)(T_ / BT));
  flash_bwd_dq_kernel<T, NC, R><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dq), st, H, T_, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int NC, int R>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const float* lse, const float* delta, void* dk, void* dv,
               const Strides& st, int B, int H, int T_, int D, float scale,
               int causal, cudaStream_t stream) {
  constexpr int BT = 16 * R;
  const size_t smem = dkv_smem_bytes(D, BT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, NC, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)(T_ / BT));
  flash_bwd_dkv_kernel<T, NC, R><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), st, H, T_, D, scale, causal);
  return (int)cudaGetLastError();
}

// D buckets: (columns per thread, rows per thread) = (2, 4), (4, 4),
// (8, 4), (16, 2)
template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* g,
                const float* lse, const float* delta, void* dq,
                const Strides& st, int B, int H, int T_, int D, float scale,
                int causal, cudaStream_t s) {
  if (D <= 32)
    return launch_dq<T, 2, 4>(q, k, v, g, lse, delta, dq, st, B, H, T_, D,
                              scale, causal, s);
  if (D <= 64)
    return launch_dq<T, 4, 4>(q, k, v, g, lse, delta, dq, st, B, H, T_, D,
                              scale, causal, s);
  if (D <= 128)
    return launch_dq<T, 8, 4>(q, k, v, g, lse, delta, dq, st, B, H, T_, D,
                              scale, causal, s);
  return launch_dq<T, 16, 2>(q, k, v, g, lse, delta, dq, st, B, H, T_, D,
                             scale, causal, s);
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v, const void* g,
                 const float* lse, const float* delta, void* dk, void* dv,
                 const Strides& st, int B, int H, int T_, int D, float scale,
                 int causal, cudaStream_t s) {
  if (D <= 32)
    return launch_dkv<T, 2, 4>(q, k, v, g, lse, delta, dk, dv, st, B, H, T_,
                               D, scale, causal, s);
  if (D <= 64)
    return launch_dkv<T, 4, 4>(q, k, v, g, lse, delta, dk, dv, st, B, H, T_,
                               D, scale, causal, s);
  if (D <= 128)
    return launch_dkv<T, 8, 4>(q, k, v, g, lse, delta, dk, dv, st, B, H, T_,
                               D, scale, causal, s);
  return launch_dkv<T, 16, 2>(q, k, v, g, lse, delta, dk, dv, st, B, H, T_,
                              D, scale, causal, s);
}

bool bad_shape(int B, int H, int T_, int D) {
  return D < 8 || D > 256 || D % 8 != 0 || T_ < 64 || T_ % 64 != 0 ||
         B * H < 1;
}

}  // namespace

extern "C" int flash_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* g,
    const float* lse, const float* delta, void* dq, long long qsb,
    long long qsh, long long qst, long long ksb, long long ksh,
    long long kst, long long vsb, long long vsh, long long vst,
    long long gsb, long long gsh, long long gst, int B, int H, int T_, int D,
    float scale, int causal, int bf16, void* stream) {
  if (bad_shape(B, H, T_, D)) return (int)cudaErrorInvalidValue;
  const Strides st = {qsb, qsh, qst, ksb, ksh, kst,
                      vsb, vsh, vst, gsb, gsh, gst};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_dq<__nv_bfloat16>(q, k, v, g, lse, delta, dq, st, B, H,
                                      T_, D, scale, causal, s);
  return dispatch_dq<float>(q, k, v, g, lse, delta, dq, st, B, H, T_, D,
                            scale, causal, s);
}

extern "C" int flash_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* g,
    const float* lse, const float* delta, void* dk, void* dv, long long qsb,
    long long qsh, long long qst, long long ksb, long long ksh,
    long long kst, long long vsb, long long vsh, long long vst,
    long long gsb, long long gsh, long long gst, int B, int H, int T_, int D,
    float scale, int causal, int bf16, void* stream) {
  if (bad_shape(B, H, T_, D)) return (int)cudaErrorInvalidValue;
  const Strides st = {qsb, qsh, qst, ksb, ksh, kst,
                      vsb, vsh, vst, gsb, gsh, gst};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, g, lse, delta, dk, dv, st, B,
                                       H, T_, D, scale, causal, s);
  return dispatch_dkv<float>(q, k, v, g, lse, delta, dk, dv, st, B, H, T_, D,
                             scale, causal, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
