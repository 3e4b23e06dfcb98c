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
//   - dQ kernel: one block owns one (b*h, Q tile of BQ queries).  Q, dO,
//     lse and delta are loaded once; K and V tiles of BK keys stream.  Per
//     K tile, phase 1 forms dS^T (keys x queries) into shared memory, and
//     phase 2 adds dS.K to a float32 register accumulator of dQ.  P is not
//     stored.  Causal blocks stop at the K tile that holds their last
//     query, and the grid issues the longest Q tiles (the last ones) first.
//   - dK/dV kernel: one block owns one (b*h, K/V tile of BK keys).  K and
//     V are loaded once; Q, dO, lse and delta tiles of BQ queries stream.
//     Per Q tile, phase 1 forms P^T and dS^T (keys x queries) into shared
//     memory, and phase 2 adds P^T.dO and dS^T.Q to two float32 register
//     accumulators (dV and dK).  Causal blocks start at the diagonal Q tile
//     ((j * BK) / BQ, the TPU kernel's start_qb), and the grid issues the
//     longest K tiles (the first ones) first.
//   - Each output tile belongs to exactly one block and every sum is taken
//     in a fixed order: no atomics, so the backward is bitwise repeatable.
//     Each sum runs in index order (over d inside a product, over keys or
//     queries across tiles and inside a tile), the order of the plain
//     backward's float32 matrix products on this card.
//   q, k, v and dO are read through their (b, h, t) strides with a unit last
//   stride, so the strided views of the LM's fused QKV projection and the
//   permuted gradient of its attention-output transpose need no copy.
//
// Both kernels are register-tiled and fed by 16-byte shared loads.  Every
// tile in shared memory is float32, row-major, with row stride D + 4 (the
// dS and P tiles: their width + 4), so each operand is read as a float4
// along the axis being summed (d in phase 1, keys or queries in phase 2)
// and 8 consecutive rows fall in 8 distinct 4-bank groups.  On an H100 a
// warp-wide 16-byte shared load costs 2 wavefronts when each quarter-warp
// (8 lanes) reads at most 2 distinct addresses and 4 otherwise
// (bench/shared_load_bench.cu), so a quarter-warp shares one row of the
// operand a thread holds most of: queries in dQ, keys in dK/dV.  Rows whose
// base or stride is not a multiple of 16 bytes (the flag `vec`) are loaded
// element by element.
//
// dQ tiles.  Thread (tq, tk), tq < 8, tk < NTH / 8; a warp spans 4 tq, one
// to each quarter-warp, x 8 tk:
//   phase 1: queries tq + 8i x keys tk + (NTH / 8) j of S = Q.K^T and
//     dP = dO.V^T (rows_dot_f4), the causal mask on global positions;
//   phase 2: queries 4 (tq + 8m) .. + 3 x head columns 4 (tk + (NTH / 8) n)
//     .. + 3 of dQ += dS.K (cols_outer_f4).
// D buckets (threads, BQ, BK, blocks an SM): D <= 64 (128, 64, 32, 3), 61.4
// KB of shared memory, 151 registers, or (128, 32, 64, 3) for a grid that
// would leave SMs idle; D <= 128 (256, 64, 64, 1), 153.1 KB; D <= 256
// (256, 32, 64, 1), 209.2 KB.  Loads per FFMA, one warp, D <= 64:
// phase 1 reads 8 query rows (2 wavefronts each) and 2 key rows (4 each)
// as float4 for 8 x 2 x 4 FFMA a thread, 24 wavefronts for 64 warp-FFMA
// (2.7 a wavefront); phase 2 reads 2 float4 of dS^T (2 each) and 1 of K (4)
// a key for 32, 8 wavefronts (4 a wavefront).  The first dQ kernel's
// scalar loads issued 2 in both phases (16 for 32 FFMA, then 8 for 16).
// 32-key tiles and three blocks an SM beat 64-key tiles (8 x 4 blocks in
// phase 1, 4 a wavefront) at two blocks an SM, as for dK/dV.
//
// dK/dV tiles.  Thread (tk, tq), tk < 8, tq < NTH / 8; a warp spans 4 tk,
// one to each quarter-warp, x 8 tq:
//   phase 1: keys tk + 8i x queries tq + (NTH / 8) j of S^T = K.Q^T and
//     dP^T = V.dO^T (rows_dot_f4), the causal mask on global positions;
//   phase 2: keys 4 (tk + 8m) .. + 3 x head columns 4 (tq + (NTH / 8) n)
//     .. + 3 of dV and dK, both products in one loop (cols_outer_f4).
// In the D <= 64 bucket phase 2's 8 x 4 blocks issue 4 FFMA per wavefront
// and phase 1's 8 x 2 blocks 2.7, where the first kernel's scalar loads
// issued 2.  D buckets (threads, BK, BQ, blocks an SM): D <= 64 (128, 64,
// 32, 3), 69.6 KB of shared memory; D <= 128 (128, 32, 32, 2), 75.3 KB;
// D <= 256 (256, 32, 32, 1), 139.3 KB.
//
// What bounds it.  Per unmasked (q, k) pair the dQ kernel does 3 products of
// length D (q.k, dO.v, ds.k) and the dK/dV kernel 4 (q.k, dO.v, p.dO, ds.q):
// at the LM's shapes (T = 1024, D = 64) far more operations than bytes, so
// both are bound by arithmetic on this card.  Both run it on the CUDA cores
// in float32 FFMA fed from shared memory; the SM issues 4 warp-FFMA per
// shared-memory wavefront, so at 2.7-4 FFMA a wavefront the shared-memory
// pipe is as near a limit as the FFMA.  A block does not overlap its tile
// loads with its math; the SM's other blocks hide most of them (streamed
// tiles loaded once instead of per tile save under 10% of either kernel,
// bench/dq_variants.py, bench/dkv_variants.py), and a second buffer would
// cost a block an SM.  Tensor cores (mma.sync / wgmma on bfloat16 tiles)
// and delta folded into a kernel are later work.
//
// Interface: plain C, loaded with ctypes.  Each *_launch returns the
// cudaGetLastError() code of the launch (or of the shared-memory attribute
// call); the Python wrapper raises on it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt, gb, gh, gt;
};

// ------------------------------------------------- shared building blocks
// Building blocks of the register-tiled kernels: every shared-memory tile
// is float32, row-major, with a row stride that is a multiple of 4 floats
// (16 bytes), so each operand is read as float4.

// A (rows, D) tile of one (b, h) slice into shared memory as float32, row
// stride ld.  vec: the slice's base and row stride are multiples of 16
// bytes, so rows are read in 16-byte pieces (4 floats or 8 bfloat16s);
// otherwise element by element.
template <int NTH>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long st, int row0, int rows,
                                          int D, int ld, int vec, int tid) {
  if (vec) {
    const int D4 = D >> 2;
    for (int i = tid; i < rows * D4; i += NTH) {
      const int r = i / D4, c = i - r * D4;
      const float4 x = __ldg(
          reinterpret_cast<const float4*>(src + (row0 + r) * st) + c);
      *reinterpret_cast<float4*>(dst + r * ld + 4 * c) = x;
    }
  } else {
    for (int i = tid; i < rows * D; i += NTH) {
      const int r = i / D, c = i - r * D;
      dst[r * ld + c] = __ldg(src + (row0 + r) * st + c);
    }
  }
}

template <int NTH>
__device__ __forceinline__ void load_rows(float* dst,
                                          const __nv_bfloat16* src,
                                          long long st, int row0, int rows,
                                          int D, int ld, int vec, int tid) {
  if (vec) {
    const int D8 = D >> 3;
    for (int i = tid; i < rows * D8; i += NTH) {
      const int r = i / D8, c = i - r * D8;
      const uint4 x = __ldg(
          reinterpret_cast<const uint4*>(src + (row0 + r) * st) + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      const float2 e = __bfloat1622float2(h[2]), f = __bfloat1622float2(h[3]);
      float4* out = reinterpret_cast<float4*>(dst + r * ld + 8 * c);
      out[0] = make_float4(a.x, a.y, b.x, b.y);
      out[1] = make_float4(e.x, e.y, f.x, f.y);
    }
  } else {
    for (int i = tid; i < rows * D; i += NTH) {
      const int r = i / D, c = i - r * D;
      dst[r * ld + c] = __bfloat162float(src[(row0 + r) * st + c]);
    }
  }
}

// Shared-memory cost of the operands (measured on an H100 by
// bench/shared_load_bench.cu): a warp-wide 16-byte load takes 2 wavefronts when each
// quarter-warp (8 lanes) reads at most 2 distinct addresses, and 4 when it
// reads 4 or more; a 4-byte load takes 1.  So an operand that a quarter
// shares (the "uniform" one) costs half a wavefront a float a thread, any
// other operand one.  A thread computing an RA x RB block of products,
// RA rows of the uniform operand and RB of the other, issues RA * RB FFMA
// for RA / 2 + RB wavefronts a step of d; the SM issues 4 warp FFMA per
// wavefront, so RA = 8, RB = 4 balances the two.

// acc[i][j] = sum over d < 4 * D4 of A[a0 + SA i][d] * B[b0 + SB j][d], d
// in increasing order: an RA x RB block of A.B^T, both operands read as
// float4 along d (the summed axis).  A is the uniform operand: the lanes
// of a quarter-warp share a0.
template <int RA, int SA, int RB, int SB>
__device__ __forceinline__ void rows_dot_f4(const float* A, int lda, int a0,
                                            const float* B, int ldb, int b0,
                                            int D4, float (&acc)[RA][RB]) {
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RB; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d4 = 0; d4 < D4; ++d4) {
    float4 a[RA];
#pragma unroll
    for (int i = 0; i < RA; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (a0 + SA * i) * lda +
                                              4 * d4);
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(B + (b0 + SB * j) * ldb + 4 * d4);
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        float x = fmaf(a[i].x, b.x, acc[i][j]);
        x = fmaf(a[i].y, b.y, x);
        x = fmaf(a[i].z, b.z, x);
        acc[i][j] = fmaf(a[i].w, b.w, x);
      }
    }
  }
}

// acc[p][4m + i][4n + c] += sum over r < NR of A[p][r][4 (a0 + SA m) + i]
// * B[p][r][4 (b0 + SB n) + c] for each of NP products p, rows r in
// increasing order, for the pieces b0 + SB n < D4: 4MA x 4NB blocks of
// A^T.B, both operands read as float4 along their rows.  A is the uniform
// operand (a quarter-warp shares a0).  The products share the loop, so a
// step of r issues NP times the independent FFMA.
template <int NP, int NR, int MA, int SA, int NB, int SB>
__device__ __forceinline__ void cols_outer_f4(
    const float* const (&A)[NP], int lda, int a0,
    const float* const (&B)[NP], int ldb, int b0, int D4,
    float (&acc)[NP][4 * MA][4 * NB]) {
#pragma unroll 2
  for (int r = 0; r < NR; ++r) {
    float a[NP][4 * MA];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int m = 0; m < MA; ++m) {
        const float4 a4 = *reinterpret_cast<const float4*>(
            A[p] + r * lda + 4 * (a0 + SA * m));
        a[p][4 * m] = a4.x;
        a[p][4 * m + 1] = a4.y;
        a[p][4 * m + 2] = a4.z;
        a[p][4 * m + 3] = a4.w;
      }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int c4 = b0 + SB * n;
      if (c4 < D4) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float4 b4 =
              *reinterpret_cast<const float4*>(B[p] + r * ldb + 4 * c4);
          const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4 * MA; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[p][i][4 * n + c] =
                  fmaf(a[p][i], b[c], acc[p][i][4 * n + c]);
        }
      }
    }
  }
}

__device__ __forceinline__ void store4(float* dst, const float* x) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* x) {
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
  d2[0] = __floats2bfloat162_rn(x[0], x[1]);
  d2[1] = __floats2bfloat162_rn(x[2], x[3]);
}

// ------------------------------------------------------------------ dQ
// The dQ kernel's tiling: NTH threads, BQ queries a block, BK keys a
// streamed tile, head columns up to DMAX.  Thread (tq, tk), tq < 8 and
// tk < TK = NTH / 8, a warp spanning 4 tq (one a quarter-warp) x 8 tk:
//   phase 1 (S, dP): queries tq + 8i (i < RQ, uniform) x keys tk + TK j
//     (j < RK);
//   phase 2 (dQ): queries 4 (tq + 8m) .. + 3 (m < MQ, uniform) x head
//     columns 4 (tk + TK n) .. + 3 (n < NB).
template <int NTH_, int BQ_, int BK_, int DMAX_, int BLOCKS_>
struct DqTile {
  static constexpr int NTH = NTH_, BQ = BQ_, BK = BK_, DMAX = DMAX_;
  static constexpr int TK = NTH / 8;
  static constexpr int RQ = BQ / 8, RK = BK / TK;
  static constexpr int MQ = BQ / 32, NB = DMAX / (4 * TK);
  static constexpr int LDS = BQ + 4;         // dS^T row stride
  static constexpr int BLOCKS_PER_SM = BLOCKS_;
  static_assert(RQ * 8 == BQ && RK * TK == BK && MQ * 32 == BQ &&
                NB * 4 * TK == DMAX && RK >= 1 && NB >= 1, "tiling");
};

size_t dq_smem_bytes(int d, int bq, int bk) {
  return sizeof(float) * ((size_t)(2 * bq + 2 * bk) * (d + 4) +
                          (size_t)bk * (bq + 4) + 2 * (size_t)bq);
}

template <typename T, typename Tile>
__global__ void __launch_bounds__(Tile::NTH, Tile::BLOCKS_PER_SM)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Strides st, int H, int T_, int D, float scale,
                    int causal, int vec) {
  constexpr int NTH = Tile::NTH, BQ = Tile::BQ, BK = Tile::BK;
  constexpr int TK = Tile::TK, RQ = Tile::RQ, RK = Tile::RK;
  constexpr int MQ = Tile::MQ, NB = Tile::NB, LDS = Tile::LDS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = D + 4, D4 = D >> 2;
  float* Qs = smem;               // BQ x ld
  float* Gs = Qs + BQ * ld;       // dO, BQ x ld
  float* Ks = Gs + BQ * ld;       // BK x ld
  float* Vs = Ks + BK * ld;       // BK x ld
  float* Ds = Vs + BK * ld;       // dS^T, BK (k) x LDS (q)
  float* Ls = Ds + BK * LDS;      // lse, BQ
  float* Es = Ls + BQ;            // delta, BQ

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int tq = (w & 1) * 4 + (lane >> 3);
  const int tk = (w >> 1) * 8 + (lane & 7);
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest causal tiles first
  const int q0 = qt * BQ;

  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;
  load_rows<NTH>(Qs, q + b * st.qb + h * st.qh, st.qt, q0, BQ, D, ld, vec,
                 tid);
  load_rows<NTH>(Gs, g + b * st.gb + h * st.gh, st.gt, q0, BQ, D, ld, vec,
                 tid);
  for (int r = tid; r < BQ; r += NTH) {
    Ls[r] = lse[(long long)bh * T_ + q0 + r];
    Es[r] = delta[(long long)bh * T_ + q0 + r];
  }

  float acc[1][4 * MQ][4 * NB];   // dQ
#pragma unroll
  for (int i = 0; i < 4 * MQ; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NB; ++j) acc[0][i][j] = 0.f;

  // causal: up to the K tile that holds the block's last query
  const int nkb = causal ? (q0 + BQ + BK - 1) / BK : T_ / BK;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();   // the previous step is done with Ks, Vs and Ds
    load_rows<NTH>(Ks, kp, st.kt, k0, BK, D, ld, vec, tid);
    load_rows<NTH>(Vs, vp, st.vt, k0, BK, D, ld, vec, tid);
    __syncthreads();

    // phase 1: S = Q.K^T -> P in place, then dP = dO.V^T -> dS^T
    float s[RQ][RK], dp[RQ][RK];
    rows_dot_f4<RQ, 8, RK, TK>(Qs, ld, tq, Ks, ld, tk, D4, s);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int qq = tq + 8 * i, key = tk + TK * j;
        float x = s[i][j] * scale;
        if (causal && k0 + key > q0 + qq) x = NEG_INF;
        s[i][j] = expf(x - Ls[qq]);
      }
    rows_dot_f4<RQ, 8, RK, TK>(Gs, ld, tq, Vs, ld, tk, D4, dp);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int qq = tq + 8 * i, key = tk + TK * j;
        Ds[key * LDS + qq] = s[i][j] * (dp[i][j] - Es[qq]) * scale;
      }
    __syncthreads();

    // phase 2: dQ += dS.K over this tile's keys
    const float* const pa[1] = {Ds};
    const float* const pb[1] = {Ks};
    cols_outer_f4<1, BK, MQ, 8, NB, TK>(pa, LDS, tq, pb, ld, tk, D4, acc);
  }

#pragma unroll
  for (int m = 0; m < MQ; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = (long long)bh * T_ + q0 + 4 * (tq + 8 * m) + i;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int c4 = tk + TK * n;
        if (c4 < D4) store4(dq + row * D + 4 * c4, &acc[0][4 * m + i][4 * n]);
      }
    }
}

// ------------------------------------------------------------- dK / dV
// The dK/dV kernel's tiling: NTH threads, BK keys a block, BQ queries a
// streamed tile, head columns up to DMAX.  Thread (tk, tq), tk < 8 and
// tq < TQ = NTH / 8, a warp spanning 4 tk (one a quarter-warp) x 8 tq:
//   phase 1 (S^T, dP^T): keys tk + 8i (i < RK, uniform) x queries
//     tq + TQ j (j < RQ);
//   phase 2 (dV, dK): keys 4 (tk + 8m) .. + 3 (m < KV, uniform) x head
//     columns 4 (tq + TQ n) .. + 3 (n < NV).
template <int NTH_, int BK_, int BQ_, int DMAX_, int BLOCKS_>
struct DkvTile {
  static constexpr int NTH = NTH_, BK = BK_, BQ = BQ_, DMAX = DMAX_;
  static constexpr int TQ = NTH / 8;
  static constexpr int RK = BK / 8, RQ = BQ / TQ;
  static constexpr int KV = BK / 32, NV = DMAX / (4 * TQ);
  static constexpr int LDP = BK + 4;         // P / dS row stride
  static constexpr int BLOCKS_PER_SM = BLOCKS_;
  static_assert(RK * 8 == BK && RQ * TQ == BQ && KV * 32 == BK &&
                NV * 4 * TQ == DMAX && RQ >= 1 && NV >= 1, "tiling");
};

size_t dkv_smem_bytes(int d, int bk, int bq) {
  return sizeof(float) * ((size_t)(2 * bk + 2 * bq) * (d + 4) +
                          2 * (size_t)bq * (bk + 4) + 2 * (size_t)bq);
}

template <typename T, typename Tile>
__global__ void __launch_bounds__(Tile::NTH, Tile::BLOCKS_PER_SM)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Strides st, int H, int T_, int D,
                     float scale, int causal, int vec) {
  constexpr int NTH = Tile::NTH, BK = Tile::BK, BQ = Tile::BQ;
  constexpr int TQ = Tile::TQ, RK = Tile::RK, RQ = Tile::RQ;
  constexpr int KV = Tile::KV, NV = Tile::NV, LDP = Tile::LDP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = D + 4, D4 = D >> 2;
  float* Ks = smem;               // BK x ld
  float* Vs = Ks + BK * ld;       // BK x ld
  float* Qs = Vs + BK * ld;       // BQ x ld
  float* Gs = Qs + BQ * ld;       // dO, BQ x ld
  float* Ps = Gs + BQ * ld;       // P, BQ (q) x LDP (k)
  float* Ds = Ps + BQ * LDP;      // dS, BQ (q) x LDP (k)
  float* Ls = Ds + BQ * LDP;      // lse, BQ
  float* Es = Ls + BQ;            // delta, BQ

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int tk = (w & 1) * 4 + (lane >> 3);
  const int tq = (w >> 1) * 8 + (lane & 7);
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int kt = blockIdx.y;      // causal: the first K tiles are longest
  const int k0 = kt * BK;

  const T* qp = q + b * st.qb + h * st.qh;
  const T* gp = g + b * st.gb + h * st.gh;
  load_rows<NTH>(Ks, k + b * st.kb + h * st.kh, st.kt, k0, BK, D, ld, vec,
                 tid);
  load_rows<NTH>(Vs, v + b * st.vb + h * st.vh, st.vt, k0, BK, D, ld, vec,
                 tid);

  float acc[2][4 * KV][4 * NV];   // dV, dK
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < 4 * KV; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NV; ++j) acc[p][i][j] = 0.f;
  const float* const pa[2] = {Ps, Ds};

  // the TPU kernel's start_qb = (j * block_k) // block_q
  const int qb0 = causal ? k0 / BQ : 0;
  for (int qb = qb0; qb < T_ / BQ; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();   // the previous step is done with Qs, Gs, Ps and Ds
    load_rows<NTH>(Qs, qp, st.qt, q0, BQ, D, ld, vec, tid);
    load_rows<NTH>(Gs, gp, st.gt, q0, BQ, D, ld, vec, tid);
    for (int r = tid; r < BQ; r += NTH) {
      Ls[r] = lse[(long long)bh * T_ + q0 + r];
      Es[r] = delta[(long long)bh * T_ + q0 + r];
    }
    __syncthreads();

    // phase 1: S^T = K.Q^T -> P^T in place, then dP^T = V.dO^T
    float s[RK][RQ], dp[RK][RQ];
    rows_dot_f4<RK, 8, RQ, TQ>(Ks, ld, tk, Qs, ld, tq, D4, s);
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        const int key = tk + 8 * i, qq = tq + TQ * j;
        float x = s[i][j] * scale;
        if (causal && k0 + key > q0 + qq) x = NEG_INF;
        s[i][j] = expf(x - Ls[qq]);
      }
    rows_dot_f4<RK, 8, RQ, TQ>(Vs, ld, tk, Gs, ld, tq, D4, dp);
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        const int key = tk + 8 * i, qq = tq + TQ * j;
        const float p = s[i][j];
        Ps[qq * LDP + key] = p;
        Ds[qq * LDP + key] = p * (dp[i][j] - Es[qq]) * scale;
      }
    __syncthreads();

    // phase 2: dV += P^T.dO and dK += dS^T.Q over this tile's queries
    const float* const pb[2] = {Gs, Qs};
    cols_outer_f4<2, BQ, KV, 8, NV, TQ>(pa, LDP, tk, pb, ld, tq, D4, acc);
  }

#pragma unroll
  for (int m = 0; m < KV; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = (long long)bh * T_ + k0 + 4 * (tk + 8 * m) + i;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int c4 = tq + TQ * n;
        if (c4 < D4) {
          store4(dv + row * D + 4 * c4, &acc[0][4 * m + i][4 * n]);
          store4(dk + row * D + 4 * c4, &acc[1][4 * m + i][4 * n]);
        }
      }
    }
}

template <typename T, typename Tile>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const float* lse, const float* delta, void* dq,
              const Strides& st, int B, int H, int T_, int D, float scale,
              int causal, int vec, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(D, Tile::BQ, Tile::BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, Tile>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)(T_ / Tile::BQ));
  flash_bwd_dq_kernel<T, Tile><<<grid, Tile::NTH, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dq), st, H, T_, D, scale, causal, vec);
  return (int)cudaGetLastError();
}

template <typename T, typename Tile>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const float* lse, const float* delta, void* dk, void* dv,
               const Strides& st, int B, int H, int T_, int D, float scale,
               int causal, int vec, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(D, Tile::BK, Tile::BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, Tile>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)(T_ / Tile::BK));
  flash_bwd_dkv_kernel<T, Tile><<<grid, Tile::NTH, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), st, H, T_, D, scale, causal,
      vec);
  return (int)cudaGetLastError();
}

// dQ D buckets, (threads, queries a block, keys a tile, D bucket, blocks
// an SM): (128, 64, 32, 64, 3), (256, 64, 64, 128, 1), (256, 32, 64, 256,
// 1); shared memory 61.4 KB at D = 64, 153.1 KB at D = 128, 209.2 KB at
// D = 256 (bench/dq_variants.py times the tilings that lost).  At D <= 64
// a grid of 64-query tiles with fewer blocks than the card has SMs takes
// 32-query tiles instead (128, 32, 64, 64, 3), twice the blocks: they win
// where SMs would idle and lose at the LM's 768 blocks.
template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* g,
                const float* lse, const float* delta, void* dq,
                const Strides& st, int B, int H, int T_, int D, float scale,
                int causal, int vec, cudaStream_t s) {
  if (D <= 64) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (B * H * (T_ / 64) < sms)
      return launch_dq<T, DqTile<128, 32, 64, 64, 3>>(
          q, k, v, g, lse, delta, dq, st, B, H, T_, D, scale, causal, vec, s);
    return launch_dq<T, DqTile<128, 64, 32, 64, 3>>(
        q, k, v, g, lse, delta, dq, st, B, H, T_, D, scale, causal, vec, s);
  }
  if (D <= 128)
    return launch_dq<T, DqTile<256, 64, 64, 128, 1>>(
        q, k, v, g, lse, delta, dq, st, B, H, T_, D, scale, causal, vec, s);
  return launch_dq<T, DqTile<256, 32, 64, 256, 1>>(
      q, k, v, g, lse, delta, dq, st, B, H, T_, D, scale, causal, vec, s);
}

// dK/dV D buckets, (threads, keys a block, queries a tile, D bucket,
// blocks an SM): (128, 64, 32, 64, 3), (128, 32, 32, 128, 2),
// (256, 32, 32, 256, 1); shared memory 69.6 KB at D = 64, 75.3 KB at
// D = 128, 139.3 KB at D = 256
template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v, const void* g,
                 const float* lse, const float* delta, void* dk, void* dv,
                 const Strides& st, int B, int H, int T_, int D, float scale,
                 int causal, int vec, cudaStream_t s) {
  if (D <= 64)
    return launch_dkv<T, DkvTile<128, 64, 32, 64, 3>>(
        q, k, v, g, lse, delta, dk, dv, st, B, H, T_, D, scale, causal, vec,
        s);
  if (D <= 128)
    return launch_dkv<T, DkvTile<128, 32, 32, 128, 2>>(
        q, k, v, g, lse, delta, dk, dv, st, B, H, T_, D, scale, causal, vec,
        s);
  return launch_dkv<T, DkvTile<256, 32, 32, 256, 1>>(
      q, k, v, g, lse, delta, dk, dv, st, B, H, T_, D, scale, causal, vec,
      s);
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
    float scale, int causal, int bf16, int vec, void* stream) {
  if (bad_shape(B, H, T_, D)) return (int)cudaErrorInvalidValue;
  const Strides st = {qsb, qsh, qst, ksb, ksh, kst,
                      vsb, vsh, vst, gsb, gsh, gst};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_dq<__nv_bfloat16>(q, k, v, g, lse, delta, dq, st, B, H,
                                      T_, D, scale, causal, vec, s);
  return dispatch_dq<float>(q, k, v, g, lse, delta, dq, st, B, H, T_, D,
                            scale, causal, vec, s);
}

extern "C" int flash_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* g,
    const float* lse, const float* delta, void* dk, void* dv, long long qsb,
    long long qsh, long long qst, long long ksb, long long ksh,
    long long kst, long long vsb, long long vsh, long long vst,
    long long gsb, long long gsh, long long gst, int B, int H, int T_, int D,
    float scale, int causal, int bf16, int vec, void* stream) {
  if (bad_shape(B, H, T_, D)) return (int)cudaErrorInvalidValue;
  const Strides st = {qsb, qsh, qst, ksb, ksh, kst,
                      vsb, vsh, vst, gsb, gsh, gst};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, g, lse, delta, dk, dv, st, B,
                                       H, T_, D, scale, causal, vec, s);
  return dispatch_dkv<float>(q, k, v, g, lse, delta, dk, dv, st, B, H, T_, D,
                             scale, causal, vec, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
