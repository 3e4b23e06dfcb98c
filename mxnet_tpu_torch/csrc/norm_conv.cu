// NormConv for Hopper (sm_90a): y = conv(relu(x*scale + shift), w), with
// optional float32 per-output-channel sum and sum of squares of y.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_conv.py::_nc_kernel (launched
// by _nc_pallas_fwd).  Same contract: x NHWC (N, H, W, Cin), w HWIO
// (K, K, Cin, Cout), K in {1, 3} (any K works here), stride 1/2, pad 0/1,
// y NHWC in x's dtype (float32 or bfloat16), float32 accumulation, and the
// statistics taken from the complete float32 sum before the downcast.
//
// Design.  The TPU kernel keeps one whole image in VMEM and runs the taps as
// a sequential grid; Hopper runs blocks in no order on 132 SMs, so this is
// an implicit GEMM: M = N*OH*OW rows (output pixels), Ncol = Cout, and a
// reduction of STEPS = K*K*ceil(Cin/16) steps, each one tap and 16 input
// channels.  A block of 128 threads owns one tile of (M, Cout):
//   tile 0: 64 x 64,  8 x 4 float32 accumulators a thread, 4 blocks an SM;
//   tile 1: 64 x 128, 8 x 8 accumulators, 3 blocks an SM.
// nc_plan takes tile 1 where Cout is a multiple of 128 and its grid has at
// least SPLIT_BELOW blocks an SM (the large grids of stages 1-2), else tile
// 0; where tile 0's grid has fewer than SPLIT_BELOW blocks an SM (stage
// 3/4, and the stride-2 and Cout <= 128 convolutions of stages 1-2), it
// splits the reduction into S contiguous slices, a block per (tile,
// slice): S = min(ceil(SPLIT_TARGET * SMs / tiles), STEPS / MIN_SLICE_STEPS).
// (128 x 64 and 128 x 128 tiles of 256 threads lost at every ResNet-50
// geometry: bench/nc_variants.py.)
//
// Split-K stays deterministic and one launch.  Each slice block writes its
// float32 partial tile to a workspace, then bumps the tile's int counter
// (__threadfence, atomicAdd).  The block that finds itself last sums the
// S partials from the workspace in slice order 0, 1, ..., S-1, never in
// arrival order, resets the counter to 0 for the next launch, and does the
// epilogue: y is bitwise the same from run to run.
//
// Inner loop.  Per step a block stages the A tile (BM pixels x 16
// channels, transposed to channel-major) and the B tile (16 channels x BN)
// in shared memory as float32, double-buffered, one __syncthreads a step:
// the next step's global loads go to registers after the FMAs of the
// current step and on to the other buffer.  Issuing them before the FMAs
// was measured 3% slower over a forward and spills at tile 1
// (bench/nc_variants.py): the loaded registers stay live through the FMAs,
// and three or four blocks an SM already hide the load latency.
// The prologue is applied in registers between the global load and the
// shared store: padded taps store 0 AFTER the prologue (the TPU kernel pads
// relu(x*s+t), not x).  x is read as 16 bytes along channels (4 float32 or
// 8 bfloat16) and w as 16 bytes along Cout, when the wrapper finds Cin,
// Cout and the bases aligned (the vec flags); otherwise element by element.
//   A warp's threads sit 8 (along Cout) x 4 (along M): each quarter-warp
// shares one row group of A (a broadcast, 2 wavefronts a 16-byte load on an
// H100) and reads 8 consecutive float4 of B (4 wavefronts): tile 0 does 32
// FFMA for 8 wavefronts a channel, tile 1 64 for 12 (two float4 of B), 4
// and 5.3 FFMA a wavefront, against 2.7 for the 4 x 4 thread tile before
// them (bench/shared_load_bench.cu measured the wavefront costs).
// Global loads travel as raw 16-byte uint4 words in registers (a copy of
// an __nv_bfloat16 struct is not a 16-byte load) and are widened to
// float32 at the shared store.
//
// Rounding.  The prologue rounds exactly as the plain PyTorch version does:
// scale and shift are cast to x's dtype by the caller, x*scale and +shift
// are two separately rounded operations (no fused multiply-add), and for
// bfloat16 each result is rounded to bfloat16.  Only the order of the
// float32 sums of the convolution differs from the plain version's.
//
// Statistics.  The block holding a tile's complete sums reduces its valid
// rows (rows past M are masked) per channel through shared memory in a
// fixed order, then adds one partial per channel into a zeroed float32
// (Cout,) buffer with atomicAdd (so the sums, not y, vary in their last
// bits between runs).
//
// What bounds it.  At ResNet-50 shapes the convolution has 64-4608 MACs per
// input element, far above the card's ~20 FLOP/byte float32 (CUDA core)
// ridge, so the bound is arithmetic.  This kernel runs its MACs on the CUDA
// cores in float32 (FFMA) from shared memory; tensor cores (wgmma on
// bfloat16, TMA-fed tiles) are later work.  Both dtypes accumulate in
// float32 on the CUDA cores.
//
// Interface: plain C, loaded with ctypes.  nc_plan returns the tile and S
// that nc_launch is then given (or a forced choice, checked); nc_launch
// returns the cudaGetLastError() code of the launch; the wrapper raises on
// either's nonzero code.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BK = 16;               // input channels a step
constexpr int TM = 8;                // accumulator rows a thread
constexpr int SPLIT_BELOW = 2;       // split grids under 2 blocks an SM
constexpr int SPLIT_TARGET = 6;      // into about 6 blocks an SM
constexpr int MIN_SLICE_STEPS = 16;  // of at least 16 steps a slice

// BM x BN tile, TN accumulator columns a thread, MINB blocks an SM
template <int BM_, int BN_, int TN_, int MINB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TN = TN_, MINB = MINB_;
  static constexpr int NT = (BM_ / TM) * (BN_ / TN_);
};
using NcTile = Tile<64, 64, 4, 4>;    // tile 0
using NcWide = Tile<64, 128, 8, 3>;   // tile 1

// the convolution, passed by value
struct Conv {
  long long M;
  int h, wd, cin, cout, k, stride, pad, oh, ow;
  int relu, prologue, stats, vec_x, vec_w;
  int nchunk, steps;
};

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

__device__ __forceinline__ unsigned word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// Per dtype: VEC elements in 16 bytes, element j of a raw uint4 as float,
// and the prologue x*scale + shift in x's dtype, each operation rounded on
// its own (no fused multiply-add; for bfloat16 each result rounded to
// bfloat16), as the plain version rounds it
template <typename T> struct Dt;
template <> struct Dt<float> {
  using Bits = unsigned;
  static constexpr int VEC = 4;
  static __device__ __forceinline__ float elem(const uint4& r, int j) {
    return __uint_as_float(word(r, j));
  }
  static __device__ __forceinline__ float apply(float x, float s, float t) {
    return __fadd_rn(__fmul_rn(x, s), t);
  }
};
template <> struct Dt<__nv_bfloat16> {
  using Bits = unsigned short;
  static constexpr int VEC = 8;
  static __device__ __forceinline__ float elem(const uint4& r, int j) {
    const unsigned u = word(r, j >> 1);
    return __uint_as_float((j & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float apply(float x, float s, float t) {
    return round(__fadd_rn(round(__fmul_rn(x, s)), t));
  }
};

// VEC elements from p as raw bits: one 16-byte load when vec, else element
// by element with the ones past `avail` zero
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, int avail, int vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  using B = typename Dt<T>::Bits;
  constexpr int PER = 4 / sizeof(B);   // elements a 32-bit word
  const B* q = reinterpret_cast<const B*>(p);
  unsigned u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < Dt<T>::VEC; ++j)
    if (j < avail) u[j / PER] |= (unsigned)q[j] << (32 / PER * (j % PER));
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// four float32 sums to y in T: one 16- or 8-byte store
__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* v) {
  unsigned u[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    u[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]))
            << 16);
  *reinterpret_cast<uint2*>(dst) = make_uint2(u[0], u[1]);
}

template <class TL>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * BK * (TL::BM + 4) + 2 * BK * TL::BN) + 16;
}

template <typename T, class TL>
__global__ void __launch_bounds__(TL::NT, TL::MINB)
nc_kernel(const T* __restrict__ x, const T* __restrict__ w,
          const T* __restrict__ scale, const T* __restrict__ shift,
          T* __restrict__ y, float* __restrict__ ysum,
          float* __restrict__ ysq, float* __restrict__ ws,
          int* __restrict__ counters, Conv g, int splits) {
  constexpr int BM = TL::BM, BN = TL::BN, TN = TL::TN, NT = TL::NT;
  constexpr int VEC = Dt<T>::VEC;          // elements a 16-byte load
  constexpr int LDA = BM + 4;              // A rows: keeps the stores apart
  constexpr int TY = BM / TM;
  constexpr int CPR = BK / VEC;            // 16-byte pieces of a pixel's step
  constexpr int A_PIECES = BM * CPR;
  constexpr int A_SLOTS = (A_PIECES + NT - 1) / NT;
  constexpr int BPR = BN / VEC;            // 16-byte pieces of a w row
  constexpr int B_PIECES = BK * BPR;
  constexpr int B_SLOTS = (B_PIECES + NT - 1) / NT;
  static_assert(NT % CPR == 0, "a thread keeps one channel group");
  static_assert(BN / TN == 16 && TM == 8, "the warp layout below");
  static_assert(2 * TY * BN <= 2 * BK * LDA, "statistics fit in A");

  extern __shared__ float4 nc_smem[];
  float* const As = reinterpret_cast<float*>(nc_smem);   // [2][BK][LDA]
  float* const Bs = As + 2 * BK * LDA;                    // [2][BK][BN]
  int* const last_flag = reinterpret_cast<int*>(Bs + 2 * BK * BN);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7);   // 16 along Cout
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // TY along M
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A pieces: pixel row ar[i] of the tile, channels cg .. cg + VEC - 1 of
  // the step's 16; a row past M or a padded tap reads nothing
  const int cg = (tid % CPR) * VEC;
  long long abase[A_SLOTS];
  int aiy[A_SLOTS], aix[A_SLOTS], ar[A_SLOTS];
#pragma unroll
  for (int i = 0; i < A_SLOTS; ++i) {
    const int s = tid + i * NT;
    ar[i] = s / CPR;
    const long long m = m0 + ar[i];
    aiy[i] = -(1 << 29);   // out of bounds at every tap
    aix[i] = 0;
    abase[i] = 0;
    if (s < A_PIECES && m < g.M) {
      const long long img = m / ((long long)g.oh * g.ow);
      const int rem = (int)(m - img * g.oh * g.ow);
      aiy[i] = (rem / g.ow) * g.stride - g.pad;
      aix[i] = (rem % g.ow) * g.stride - g.pad;
      abase[i] = img * g.h * g.wd * g.cin;
    }
  }

  uint4 ra[A_SLOTS], rb[B_SLOTS], rs, rt;   // raw bits of VEC elements
  int a_ok = 0;    // bit i: piece i is an in-bounds tap of a row below M
  int a_nc = 0;    // channels of this thread's group below Cin

  auto load = [&](int s) {
    const int tap = s / g.nchunk;
    const int c0 = (s - tap * g.nchunk) * BK;
    const int kh = tap / g.k, kw = tap - kh * g.k;
    const int c = c0 + cg;
    a_nc = g.cin - c;
    a_ok = 0;
    if (g.prologue && c < g.cin) {
      rs = load16(scale + c, g.cin - c, g.vec_x);
      rt = load16(shift + c, g.cin - c, g.vec_x);
    }
#pragma unroll
    for (int i = 0; i < A_SLOTS; ++i) {
      const int iy = aiy[i] + kh, ix = aix[i] + kw;
      if (c < g.cin && iy >= 0 && iy < g.h && ix >= 0 && ix < g.wd) {
        ra[i] = load16(x + abase[i] + ((long long)iy * g.wd + ix) * g.cin + c,
                       g.cin - c, g.vec_x);
        a_ok |= 1 << i;
      }
    }
#pragma unroll
    for (int j = 0; j < B_SLOTS; ++j) {
      const int p = tid + j * NT;
      const int cc = c0 + p / BPR;
      const int co = n0 + (p % BPR) * VEC;
      rb[j] = make_uint4(0u, 0u, 0u, 0u);
      if (p < B_PIECES && cc < g.cin && co < g.cout)
        rb[j] = load16(w + ((long long)tap * g.cin + cc) * g.cout + co,
                       g.cout - co, g.vec_w);
    }
  };

  auto store = [&](int buf) {
    float* const A = As + buf * BK * LDA;
    float* const B = Bs + buf * BK * BN;
#pragma unroll
    for (int i = 0; i < A_SLOTS; ++i) {
      if (A_PIECES % NT != 0 && tid + i * NT >= A_PIECES) continue;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float v = 0.f;
        if (((a_ok >> i) & 1) && j < a_nc) {
          v = Dt<T>::elem(ra[i], j);
          if (g.prologue) {
            v = Dt<T>::apply(v, Dt<T>::elem(rs, j), Dt<T>::elem(rt, j));
            if (g.relu) v = relu_f(v);
          }
        }
        A[(cg + j) * LDA + ar[i]] = v;
      }
    }
#pragma unroll
    for (int j = 0; j < B_SLOTS; ++j) {
      const int p = tid + j * NT;
      if (B_PIECES % NT != 0 && p >= B_PIECES) continue;
      float* const dst = B + (p / BPR) * BN + (p % BPR) * VEC;
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q)
        *reinterpret_cast<float4*>(dst + 4 * q) = make_float4(
            Dt<T>::elem(rb[j], 4 * q), Dt<T>::elem(rb[j], 4 * q + 1),
            Dt<T>::elem(rb[j], 4 * q + 2), Dt<T>::elem(rb[j], 4 * q + 3));
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  auto compute = [&](int buf) {
    const float* const A = As + buf * BK * LDA;
    const float* const B = Bs + buf * BK * BN;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(A + kk * LDA + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(A + kk * LDA + BM / 2 + ty * 4);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[TN];
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 b4 = *reinterpret_cast<const float4*>(
            B + kk * BN + q * (BN / 2) + tx * 4);
        b[4 * q] = b4.x;
        b[4 * q + 1] = b4.y;
        b[4 * q + 2] = b4.z;
        b[4 * q + 3] = b4.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  };

  // this block's slice of the reduction: steps [s0, s1)
  const int z = blockIdx.z;
  const int s0 = (int)((long long)g.steps * z / splits);
  const int s1 = (int)((long long)g.steps * (z + 1) / splits);
  load(s0);
  store(0);
  __syncthreads();
  for (int s = s0; s < s1; ++s) {
    const int cur = (s - s0) & 1;
    const bool more = s + 1 < s1;
    compute(cur);
    if (more) load(s + 1);
    if (more) store(cur ^ 1);
    __syncthreads();
  }

  if (splits > 1) {
    // partial tile to the workspace, float4 q of thread tid at
    // (q * NT + tid) * 4: a warp's store is 512 contiguous bytes
    constexpr int TILE_FLOATS = BM * BN;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* const wtile = ws + (long long)tile * splits * TILE_FLOATS;
    float* const part = wtile + (long long)z * TILE_FLOATS;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < TN / 4; ++q)
        *reinterpret_cast<float4*>(part + ((i * (TN / 4) + q) * NT + tid) *
                                              4) =
            make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                        acc[i][4 * q + 3]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int last = atomicAdd(&counters[tile], 1) == splits - 1;
      if (last) counters[tile] = 0;   // ready for the next launch
      *last_flag = last;
    }
    __syncthreads();
    if (!*last_flag) return;
    __threadfence();
    // the complete sum, in slice order
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float* src = wtile + ((i * (TN / 4) + q) * NT + tid) * 4;
        float4 sum = __ldcg(reinterpret_cast<const float4*>(src));
        for (int zz = 1; zz < splits; ++zz) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(
              src + (long long)zz * TILE_FLOATS));
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        acc[i][4 * q] = sum.x;
        acc[i][4 * q + 1] = sum.y;
        acc[i][4 * q + 2] = sum.z;
        acc[i][4 * q + 3] = sum.w;
      }
  }

  // epilogue: thread rows ty*4 + i and BM/2 + ty*4 + i, columns tx*4 + c
  // (and BN/2 + tx*4 + c when TN = 8)
  const bool vec_y = g.cout % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + (i / 4) * (BM / 2) + ty * 4 + (i % 4);
    if (m >= g.M) continue;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int co = n0 + q * (BN / 2) + tx * 4;
      T* const dst = y + m * g.cout + co;
      if (vec_y && co < g.cout) {
        store4(dst, &acc[i][4 * q]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (co + c < g.cout) dst[c] = from_f<T>(acc[i][4 * q + c]);
      }
    }
  }

  if (g.stats) {
    float* const red_s = As;             // [TY][BN], the loop is done
    float* const red_q = As + TY * BN;   // with A (last __syncthreads)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float sv = 0.f, qv = 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (m0 + (i / 4) * (BM / 2) + ty * 4 + (i % 4) < g.M) {
          sv += acc[i][j];
          qv += acc[i][j] * acc[i][j];
        }
      }
      const int col = (j / 4) * (BN / 2) + tx * 4 + (j % 4);
      red_s[ty * BN + col] = sv;
      red_q[ty * BN + col] = qv;
    }
    __syncthreads();
    for (int c = tid; c < BN; c += NT) {
      if (n0 + c >= g.cout) continue;
      float sv = 0.f, qv = 0.f;
      for (int t = 0; t < TY; ++t) {
        sv += red_s[t * BN + c];
        qv += red_q[t * BN + c];
      }
      atomicAdd(&ysum[n0 + c], sv);
      atomicAdd(&ysq[n0 + c], qv);
    }
  }
}

template <typename T, class TL>
int launch(const void* x, const void* w, const void* scale,
           const void* shift, void* y, float* ysum, float* ysq, float* ws,
           int* counters, const Conv& g, int splits, cudaStream_t s) {
  const dim3 grid((unsigned)((g.M + TL::BM - 1) / TL::BM),
                  (unsigned)((g.cout + TL::BN - 1) / TL::BN),
                  (unsigned)splits);
  const size_t smem = smem_bytes<TL>();
  nc_kernel<T, TL><<<grid, TL::NT, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(scale), static_cast<const T*>(shift),
      static_cast<T*>(y), ysum, ysq, ws, counters, g, splits);
  return (int)cudaGetLastError();
}

const int TILE_BM[2] = {NcTile::BM, NcWide::BM};
const int TILE_BN[2] = {NcTile::BN, NcWide::BN};

long long tiles_of(long long M, int cout, int tile) {
  return ((M + TILE_BM[tile] - 1) / TILE_BM[tile]) *
         ((cout + TILE_BN[tile] - 1) / TILE_BN[tile]);
}

int steps_of(int cin, int k) { return k * k * ((cin + BK - 1) / BK); }

}  // namespace

// The tile and split of a launch.  tile < 0 and splits < 1 ask for the
// choice by grid size (header comment); a caller may force either, as
// bench/nc_variants.py does.  Fills plan[0..4] with the tile, its BM and
// BN, S and the number of output tiles (with S > 1 the workspace holds
// S * tiles * BM * BN floats and the counters `tiles` ints, all 0).
extern "C" int nc_plan(int n, int oh, int ow, int cin, int cout, int k,
                       int tile, int splits, int* plan) {
  const long long M = (long long)n * oh * ow;
  if (M < 1 || cin < 1 || cout < 1 || k < 1 || tile > 1)
    return (int)cudaErrorInvalidValue;
  const int steps = steps_of(cin, k);
  int sms = 0;
  if (tile < 0 || splits < 1) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const long long few = (long long)SPLIT_BELOW * sms;
  if (tile < 0)
    tile = cout % NcWide::BN == 0 && tiles_of(M, cout, 1) >= few ? 1 : 0;
  const long long tiles = tiles_of(M, cout, tile);
  if (splits < 1) {
    splits = 1;
    if (tiles < few) {
      const long long by_grid = (SPLIT_TARGET * sms + tiles - 1) / tiles;
      const long long by_steps = steps / MIN_SLICE_STEPS;
      splits = (int)(by_grid < by_steps ? by_grid : by_steps);
      if (splits < 1) splits = 1;
    }
  }
  if (splits > steps || tiles > (1LL << 30) / splits)
    return (int)cudaErrorInvalidValue;
  plan[0] = tile;
  plan[1] = TILE_BM[tile];
  plan[2] = TILE_BN[tile];
  plan[3] = splits;
  plan[4] = (int)tiles;
  return 0;
}

extern "C" int nc_launch(const void* x, const void* w, const void* scale,
                         const void* shift, void* y, float* ysum, float* ysq,
                         float* ws, int* counters, int n, int h, int wd,
                         int cin, int cout, int k, int stride, int pad,
                         int oh, int ow, int relu, int prologue, int stats,
                         int bf16, int vec_x, int vec_w, int tile,
                         int splits, void* stream) {
  Conv g;
  g.M = (long long)n * oh * ow;
  g.h = h;
  g.wd = wd;
  g.cin = cin;
  g.cout = cout;
  g.k = k;
  g.stride = stride;
  g.pad = pad;
  g.oh = oh;
  g.ow = ow;
  g.relu = relu;
  g.prologue = prologue;
  g.stats = stats;
  g.vec_x = vec_x;
  g.vec_w = vec_w;
  g.nchunk = (cin + BK - 1) / BK;
  g.steps = steps_of(cin, k);
  if (g.M < 1 || cout < 1 || tile < 0 || tile > 1 || splits < 1 ||
      splits > g.steps || (splits > 1 && (ws == nullptr ||
                                          counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (tile == 1)
    return bf16 ? launch<BF, NcWide>(x, w, scale, shift, y, ysum, ysq, ws,
                                     counters, g, splits, s)
                : launch<float, NcWide>(x, w, scale, shift, y, ysum, ysq, ws,
                                        counters, g, splits, s);
  return bf16 ? launch<BF, NcTile>(x, w, scale, shift, y, ysum, ysq, ws,
                                   counters, g, splits, s)
              : launch<float, NcTile>(x, w, scale, shift, y, ysum, ysq, ws,
                                      counters, g, splits, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
