// Flash attention forward for Hopper (sm_90a): O = softmax(Q*K^T*scale)*V
// over (B, H, T, D) self-attention, causal optional, and the per-row
// log-sum-exp lse = m + log(l) that the blocked backward reads.
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
// the Q tiles as a sequential grid.  A Hopper block has at most 227 KB of
// shared memory and blocks run in parallel, so here one block owns one
// (b*h, Q tile of BQ queries): the Q tile is loaded once (scaled in float32
// on its way to shared memory), K and V stream through shared memory in
// tiles of BK keys, and per K tile
//   phase 1: S = Q.K^T (rows_dot_f4), the causal mask on global positions,
//     the online softmax (below), and P = exp(S - m_new) stored transposed
//     (keys x queries, row stride BQ + 4);
//   phase 2: the accumulator rows are rescaled by their correction
//     exp(m_old - m_new) and O += P.V is added to them (cols_outer_f4).
// Causal blocks stop at the K tile that holds their last query (the K tiles
// wholly above the diagonal are skipped, the TPU kernel's num_kb), and the
// grid issues the longest Q tiles (the last ones) first.  q, k and v are
// read through their (b, h, t) strides with a unit last stride, so the
// strided views of the LM's fused QKV projection need no copy.
//
// Tiles.  Thread (tq, tk) = (tid / TK, tid % TK), tq < 8, TK = NTH / 8, so a
// quarter-warp (8 lanes) shares one tq:
//   phase 1: queries tq + 8i (i < RQ, the operand a quarter-warp shares) x
//     keys tk + TK j (j < RK);
//   phase 2: queries 4 (tq + 8m) .. + 3 (m < MQ, shared) x head columns
//     4 (tk + TK n) .. + 3 (n < NB).
// A query row's TK phase-1 threads are lanes of one warp, so its maximum
// and its sum over the tile's keys are warp shuffles over TK lanes (a
// fixed tree; every other sum runs in index order, and there are no
// atomics: o and lse are bitwise the same over two launches).  Each of
// those threads keeps the row's running m and l in registers; the row's
// correction factor goes to phase 2's threads, which hold other rows,
// through shared memory, as do the final l values.  The tile (threads, BQ,
// BK, blocks an SM, K/V buffers) is chosen by D bucket and by grid size
// (flash_fwd_plan, the table below).
//
// What bounds it.  Per unmasked (q, k) pair attention does 2 products of
// length D (q.k and p.v): at the LM's shapes (T = 1024, D = 64) far more
// operations than bytes, so on this card it is bound by arithmetic, run
// here on the CUDA cores in float32 FFMA fed from shared memory.  The SM
// issues 4 warp-FFMA per shared-memory wavefront, and a warp-wide 16-byte
// shared load costs 2 wavefronts when each quarter-warp reads at most 2
// distinct addresses and 4 otherwise (bench/shared_load_bench.cu), so the
// shared-memory pipe limits the products as much as the FFMA pipe.  Every
// tile in shared memory is float32, row-major, with a row stride of a
// multiple of 4 floats plus 4 (D + 4; the P tile BQ + 4), so each operand
// is read as a float4 along the axis being summed and 8 consecutive rows
// fall in 8 distinct 4-bank groups.  In the D <= 64 tile phase 1 reads 8
// query rows (2 wavefronts each) and 2 key rows (4 each) a step of 4 d for
// 8 x 2 x 4 FFMA a thread, 2.7 FFMA a wavefront; phase 2 reads 2 float4 of
// P^T (2 each) and 1 of V (4) a key for 32, 4 FFMA a wavefront.  The first
// kernel's scalar loads issued 2 in both phases.  Where shared memory
// leaves the blocks an SM unchanged (or the grid has under one block an
// SM, which nothing else would hide), a second K/V buffer takes the next
// tile's copy (cp.async for float32 rows in 16-byte pieces) while this one
// is used.  Rows whose base or stride is not a multiple of 16 bytes (the
// flag `vec`) are loaded element by element.  bench/fwd_variants.py holds
// the ablations, the second buffer switched off and the tilings that lost.
// Tensor cores (mma.sync / wgmma on bfloat16 tiles) are later work.
//
// Interface: plain C, loaded with ctypes.  flash_fwd_plan reports the tile
// that flash_fwd_launch takes for a shape on the current device;
// flash_fwd_launch returns the cudaGetLastError() code of the launch (or of
// the device query or the shared-memory attribute call); the Python wrapper
// raises on it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long qb, qh, qt, kb, kh, kt, vb, vh, vt;
};

// ------------------------------------------------- shared building blocks
// A (rows, D) tile of one (b, h) slice into shared memory as float32 times
// mul, row stride ld.  vec: the slice's base and row stride are multiples
// of 16 bytes, so rows are read in 16-byte pieces (4 floats or 8
// bfloat16s); otherwise element by element.
template <int NTH>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long st, int row0, int rows,
                                          int D, int ld, int vec, int tid,
                                          float mul) {
  if (vec) {
    const int D4 = D >> 2;
    for (int i = tid; i < rows * D4; i += NTH) {
      const int r = i / D4, c = i - r * D4;
      const float4 x = __ldg(
          reinterpret_cast<const float4*>(src + (row0 + r) * st) + c);
      *reinterpret_cast<float4*>(dst + r * ld + 4 * c) =
          make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
    }
  } else {
    for (int i = tid; i < rows * D; i += NTH) {
      const int r = i / D, c = i - r * D;
      dst[r * ld + c] = __ldg(src + (row0 + r) * st + c) * mul;
    }
  }
}

template <int NTH>
__device__ __forceinline__ void load_rows(float* dst,
                                          const __nv_bfloat16* src,
                                          long long st, int row0, int rows,
                                          int D, int ld, int vec, int tid,
                                          float mul) {
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
      out[0] = make_float4(a.x * mul, a.y * mul, b.x * mul, b.y * mul);
      out[1] = make_float4(e.x * mul, e.y * mul, f.x * mul, f.y * mul);
    }
  } else {
    for (int i = tid; i < rows * D; i += NTH) {
      const int r = i / D, c = i - r * D;
      dst[r * ld + c] = __bfloat162float(src[(row0 + r) * st + c]) * mul;
    }
  }
}

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

// acc[4m + i][4n + c] += sum over r < NR of A[r][4 (a0 + SA m) + i] *
// B[r][4 (b0 + SB n) + c], rows r in increasing order, for the pieces
// b0 + SB n < D4: a 4MA x 4NB block of A^T.B, both operands read as float4
// along their rows.  A is the uniform operand (a quarter-warp shares a0).
template <int NR, int MA, int SA, int NB, int SB>
__device__ __forceinline__ void cols_outer_f4(const float* A, int lda,
                                              int a0, const float* B,
                                              int ldb, int b0, int D4,
                                              float (&acc)[4 * MA][4 * NB]) {
#pragma unroll 2
  for (int r = 0; r < NR; ++r) {
    float a[4 * MA];
#pragma unroll
    for (int m = 0; m < MA; ++m) {
      const float4 a4 =
          *reinterpret_cast<const float4*>(A + r * lda + 4 * (a0 + SA * m));
      a[4 * m] = a4.x;
      a[4 * m + 1] = a4.y;
      a[4 * m + 2] = a4.z;
      a[4 * m + 3] = a4.w;
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int c4 = b0 + SB * n;
      if (c4 < D4) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(B + r * ldb + 4 * c4);
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4 * MA; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][4 * n + c] = fmaf(a[i], b[c], acc[i][4 * n + c]);
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

// cp.async: a 16-byte copy from global to shared memory that does not wait
// for the data (one commit group a tile, waited for one tile later); the
// host pass, which never runs it, and the host emulation copy at once
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
#else
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

__device__ __forceinline__ void cp_async_wait1() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\n" ::);
#endif
}

// load_rows without waiting: float32 rows in 16-byte pieces go by cp.async
// (complete after the next cp_async_wait1 and __syncthreads), others as
// load_rows
template <int NTH>
__device__ __forceinline__ void fetch_rows(float* dst, const float* src,
                                           long long st, int row0, int rows,
                                           int D, int ld, int vec, int tid) {
  if (vec) {
    const int D4 = D >> 2;
    for (int i = tid; i < rows * D4; i += NTH) {
      const int r = i / D4, c = i - r * D4;
      cp_async16(dst + r * ld + 4 * c, src + (row0 + r) * st + 4 * c);
    }
  } else {
    load_rows<NTH>(dst, src, st, row0, rows, D, ld, vec, tid, 1.f);
  }
}

template <int NTH>
__device__ __forceinline__ void fetch_rows(float* dst,
                                           const __nv_bfloat16* src,
                                           long long st, int row0, int rows,
                                           int D, int ld, int vec, int tid) {
  load_rows<NTH>(dst, src, st, row0, rows, D, ld, vec, tid, 1.f);
}

// the maximum and the sum over the TK lanes of a warp that share a row
// (lanes tk = 0 .. TK - 1 of one tq), as a fixed tree
template <int TK>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = TK / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int TK>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = TK / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ------------------------------------------------------------- the kernel
// The tiling: NTH threads, BQ queries a block, BK keys a streamed tile,
// head columns up to DMAX, BLOCKS_ blocks an SM (the register cap of
// __launch_bounds__), BUFS_ K/V buffers (2: the next tile's copy is in
// flight while this one is used).  Thread (tq, tk) = (tid / TK, tid % TK).
template <int NTH_, int BQ_, int BK_, int DMAX_, int BLOCKS_, int BUFS_>
struct FwdTile {
  static constexpr int NTH = NTH_, BQ = BQ_, BK = BK_, DMAX = DMAX_;
  static constexpr int BUFS = BUFS_;
  static constexpr int TK = NTH / 8;
  static constexpr int RQ = BQ / 8, RK = BK / TK;
  static constexpr int MQ = BQ / 32, NB = DMAX / (4 * TK);
  static constexpr int LDP = BQ + 4;         // P^T row stride
  static constexpr int BLOCKS_PER_SM = BLOCKS_;
  static_assert(RQ * 8 == BQ && RK * TK == BK && MQ * 32 == BQ &&
                    NB * 4 * TK == DMAX && RK >= 1 && NB >= 1 && TK >= 8 &&
                    TK <= 32 && (TK & (TK - 1)) == 0 &&
                    (BUFS == 1 || BUFS == 2),
                "tiling");
};

size_t smem_bytes(int d, int bq, int bk, int bufs) {
  return sizeof(float) * ((size_t)(bq + 2 * bufs * bk) * (d + 4) +
                          (size_t)bk * (bq + 4) + 2 * (size_t)bq);
}

template <typename T, typename Tile>
__global__ void __launch_bounds__(Tile::NTH, Tile::BLOCKS_PER_SM)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Strides st, int H, int T_, int D,
                 float scale, int causal, int vec) {
  constexpr int NTH = Tile::NTH, BQ = Tile::BQ, BK = Tile::BK;
  constexpr int TK = Tile::TK, RQ = Tile::RQ, RK = Tile::RK;
  constexpr int MQ = Tile::MQ, NB = Tile::NB, LDP = Tile::LDP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = D + 4, D4 = D >> 2;
  float* Qs = smem;               // BQ x ld, scaled
  float* Ps = Qs + BQ * ld;       // P^T, BK (k) x LDP (q)
  float* Cs = Ps + BK * LDP;      // this K tile's correction, BQ
  float* Ls = Cs + BQ;            // the final l, BQ
  float* KVs = Ls + BQ;           // BUFS x (K, V), each BK x ld

  const int tid = threadIdx.x;
  const int tq = tid / TK, tk = tid % TK;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int qt = gridDim.y - 1 - blockIdx.y;   // longest causal tiles first
  const int q0 = qt * BQ;

  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;
  load_rows<NTH>(Qs, q + b * st.qb + h * st.qh, st.qt, q0, BQ, D, ld, vec,
                 tid, scale);

  float acc[4 * MQ][4 * NB];      // O, phase 2's rows
#pragma unroll
  for (int i = 0; i < 4 * MQ; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NB; ++j) acc[i][j] = 0.f;
  float m[RQ], l[RQ];             // phase 1's rows, running max and sum
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }

  // causal: up to the K tile that holds the block's last query
  const int nkb = causal ? (q0 + BQ + BK - 1) / BK : T_ / BK;
  if (Tile::BUFS == 2) {
    fetch_rows<NTH>(KVs, kp, st.kt, 0, BK, D, ld, vec, tid);
    fetch_rows<NTH>(KVs + BK * ld, vp, st.vt, 0, BK, D, ld, vec, tid);
    cp_async_commit();
  }
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    const float* Ks = KVs + (kb & (Tile::BUFS - 1)) * 2 * BK * ld;
    const float* Vs = Ks + BK * ld;
    __syncthreads();   // the previous step is done with Ps, Cs and the
                       // K/V buffer loaded next
    if (Tile::BUFS == 2) {
      if (kb + 1 < nkb) {
        float* nk = KVs + (~kb & 1) * 2 * BK * ld;
        fetch_rows<NTH>(nk, kp, st.kt, k0 + BK, BK, D, ld, vec, tid);
        fetch_rows<NTH>(nk + BK * ld, vp, st.vt, k0 + BK, BK, D, ld, vec,
                        tid);
      }
      cp_async_commit();
      cp_async_wait1();
    } else {
      load_rows<NTH>(KVs, kp, st.kt, k0, BK, D, ld, vec, tid, 1.f);
      load_rows<NTH>(KVs + BK * ld, vp, st.vt, k0, BK, D, ld, vec, tid,
                     1.f);
    }
    __syncthreads();

    // phase 1: S = Q.K^T, the online softmax, P^T
    float s[RQ][RK];
    rows_dot_f4<RQ, 8, RK, TK>(Qs, ld, tq, Ks, ld, tk, D4, s);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qq = tq + 8 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        if (causal && k0 + tk + TK * j > q0 + qq) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mnew = fmaxf(m[i], row_max<TK>(mx));
      const float corr = expf(m[i] - mnew);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = expf(s[i][j] - mnew);
        rs += p;
        Ps[(tk + TK * j) * LDP + qq] = p;
      }
      l[i] = l[i] * corr + row_sum<TK>(rs);
      m[i] = mnew;
      if (tk == 0) Cs[qq] = corr;
    }
    __syncthreads();

    // phase 2: rescale the accumulator rows, then O += P.V
#pragma unroll
    for (int mm = 0; mm < MQ; ++mm) {
      const float4 c4 =
          *reinterpret_cast<const float4*>(Cs + 4 * (tq + 8 * mm));
      const float c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4 * NB; ++j) acc[4 * mm + i][j] *= c[i];
    }
    cols_outer_f4<BK, MQ, 8, NB, TK>(Ps, LDP, tq, Vs, ld, tk, D4, acc);
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qq = tq + 8 * i;
    const float ll = fmaxf(l[i], 1e-30f);
    if (tk == 0) {
      Ls[qq] = ll;
      lse[(long long)bh * T_ + q0 + qq] = m[i] + logf(ll);
    }
  }
  __syncthreads();
#pragma unroll
  for (int mm = 0; mm < MQ; ++mm)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qq = 4 * (tq + 8 * mm) + i;
      const float ll = Ls[qq];
      const long long row = (long long)bh * T_ + q0 + qq;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int c4 = tk + TK * n;
        if (c4 < D4) {
          float x[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) x[c] = acc[4 * mm + i][4 * n + c] / ll;
          store4(o + row * D + 4 * c4, x);
        }
      }
    }
}

// The tiles, (threads, BQ, BK, D bucket, blocks an SM, K/V buffers), and
// their shared memory at the bucket's largest D:
//   0: D <= 64              (128, 64, 32,  64, 3, 2)  61.4 KB
//   1: D <= 64, small grid  (128, 32, 64,  64, 2, 2)  87.8 KB
//   2: D <= 128             (128, 64, 32, 128, 2, 2) 110.6 KB
//   3: D <= 128, small grid (128, 32, 64, 128, 1, 2) 161.5 KB
//   4: D <= 256             (256, 32, 32, 256, 2, 1) 104.7 KB
//   5: D <= 256, small grid (256, 32, 64, 256, 1, 1) 175.9 KB
// A small grid is one of fewer 64-query blocks than the card has SMs: there
// 32-query tiles give twice the blocks, and 64-key tiles half the steps of
// the longest block.  bench/fwd_variants.py times the tilings that lost.
constexpr int NTILES = 6;
constexpr int TILES[NTILES][6] = {{128, 64, 32, 64, 3, 2},
                                  {128, 32, 64, 64, 2, 2},
                                  {128, 64, 32, 128, 2, 2},
                                  {128, 32, 64, 128, 1, 2},
                                  {256, 32, 32, 256, 2, 1},
                                  {256, 32, 64, 256, 1, 1}};

template <int I>
using TileOf = FwdTile<TILES[I][0], TILES[I][1], TILES[I][2], TILES[I][3],
                       TILES[I][4], TILES[I][5]>;

bool bad_shape(int B, int H, int T_, int D) {
  return D < 8 || D > 256 || D % 8 != 0 || T_ < 64 || T_ % 64 != 0 ||
         B < 1 || H < 1;
}

// the tile index for a shape on the current device, or a CUDA error code
// (negated) when the device cannot be queried
int plan_tile(int B, int H, int T_, int D) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  const bool small = (long long)B * H * (T_ / 64) < sms;
  if (D <= 64) return small ? 1 : 0;
  if (D <= 128) return small ? 3 : 2;
  return small ? 5 : 4;
}

template <typename T, int I>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Strides& st, int B, int H, int T_, int D, float scale,
           int causal, int vec, cudaStream_t stream) {
  using Tile = TileOf<I>;
  const size_t smem = smem_bytes(D, Tile::BQ, Tile::BK, Tile::BUFS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, Tile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)(T_ / Tile::BQ));
  flash_fwd_kernel<T, Tile><<<grid, Tile::NTH, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, st, H, T_, D, scale,
      causal, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int tile, const void* q, const void* k, const void* v, void* o,
             float* lse, const Strides& st, int B, int H, int T_, int D,
             float scale, int causal, int vec, cudaStream_t s) {
  switch (tile) {
    case 0:
      return launch<T, 0>(q, k, v, o, lse, st, B, H, T_, D, scale, causal,
                          vec, s);
    case 1:
      return launch<T, 1>(q, k, v, o, lse, st, B, H, T_, D, scale, causal,
                          vec, s);
    case 2:
      return launch<T, 2>(q, k, v, o, lse, st, B, H, T_, D, scale, causal,
                          vec, s);
    case 3:
      return launch<T, 3>(q, k, v, o, lse, st, B, H, T_, D, scale, causal,
                          vec, s);
    case 4:
      return launch<T, 4>(q, k, v, o, lse, st, B, H, T_, D, scale, causal,
                          vec, s);
    default:
      return launch<T, 5>(q, k, v, o, lse, st, B, H, T_, D, scale, causal,
                          vec, s);
  }
}

}  // namespace

// out: the tile index, then its threads, BQ, BK, D bucket, blocks an SM
// and K/V buffers
extern "C" int flash_fwd_plan(int B, int H, int T_, int D, int* out) {
  if (bad_shape(B, H, T_, D)) return (int)cudaErrorInvalidValue;
  const int tile = plan_tile(B, H, T_, D);
  if (tile < 0) return -tile;
  out[0] = tile;
  for (int i = 0; i < 6; ++i) out[1 + i] = TILES[tile][i];
  return 0;
}

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, float* lse, long long qsb,
                                long long qsh, long long qst, long long ksb,
                                long long ksh, long long kst, long long vsb,
                                long long vsh, long long vst, int B, int H,
                                int T_, int D, float scale, int causal,
                                int bf16, int vec, void* stream) {
  if (bad_shape(B, H, T_, D)) return (int)cudaErrorInvalidValue;
  const int tile = plan_tile(B, H, T_, D);
  if (tile < 0) return -tile;
  const Strides st = {qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(tile, q, k, v, o, lse, st, B, H, T_, D,
                                   scale, causal, vec, s);
  return dispatch<float>(tile, q, k, v, o, lse, st, B, H, T_, D, scale,
                         causal, vec, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
