// Greedy non-maximum suppression of MultiBoxDetection for Hopper (sm_90a):
// a suppression bitmask computed across the card, then a scan over it.
//
// Replaces no TPU kernel: the JAX package runs this loop as XLA, a
// lax.fori_loop over the score-sorted boxes with a lax.cond inside
// (mxnet_tpu/ops/contrib.py::_greedy_nms), which XLA keeps on the device as
// one loop.  Eager PyTorch would spend about five launches a box on it, and
// a host read to test each box, so the port runs it as two kernels.
//
// Contract (that of _greedy_nms, batched): boxes (B, A, 4) corner boxes and
// ids (B, A) class ids, each image's rows sorted by descending score, an
// invalid row carrying a negative id.  Row j is suppressed (its id set to
// -1) exactly when some kept row i < j is of the same class (of any class
// under force_suppress) and has IoU(i, j) >= nms_threshold; a row is kept
// when its id is >= 0 and it is not suppressed; rows that came in negative
// keep their ids.  These rules equal the fori_loop by induction over i:
// step i of the loop changes ids only when row i is still alive, i.e. kept
// (a row's class never changes, only its id to -1), and then kills exactly
// the live rows j > i of its class whose IoU reaches the threshold; a row
// that is already dead stays dead.  So after the loop row j is dead iff it
// came in invalid or some kept i < j meets the two conditions, and row i
// is kept iff it came in valid and no kept row before it suppressed it.
// ids is updated in place; float32 or float64, one type for both arrays.
//
// Design.  The IoUs do not depend on which rows are kept; only the
// decision "is row i still alive?" is serial.  So:
// (a) nms_mask_kernel computes, over the whole card, for each row i the
//     bits of the later rows j that i would suppress if kept: a 64-bit word
//     mask(i, w) holds rows j = 64 w .. 64 w + 63.  One block of 64 threads
//     a (row tile, column tile) pair, the upper-triangular pairs only; the
//     column tile's boxes and ids are staged in shared memory; thread r
//     first finds the columns of its class (a register bitmask) and then
//     takes the IoU of those alone, and writes word mask(64 bi + r, bj)
//     whole, bits j <= i clear.  The words are stored word-major (a word's
//     rows side by side), so that a tile's 64 stores, and the scan's
//     copies, are contiguous.  Every word that the scan reads is written
//     here.
// (b) nms_scan_kernel, one block an image, walks the rows in chunks of 64.
//     Warp 0 holds the removed bits of chunk c in one 64-bit register, cur:
//     row r is kept iff bit r of cur is clear, and a kept row ORs its
//     diagonal word mask(64 c + r, c) into cur.  That chain is 64 register
//     steps a chunk; the diagonal words, two in each lane, reach every lane
//     by __shfl_sync independent of cur, and no barrier and no memory
//     access is on the chain.  The other warps
//     ("folders") stage the next chunk's ids and mask words in shared
//     memory by cp.async (a barrier waits for a thread's outstanding
//     loads, measured on the card, but not for its cp.async copies), and
//     fold the rows kept in chunk c - 1 into the removed words w > c,
//     sixteen threads a word, four rows each, ORed across the lanes by
//     shuffles: the band's words in shared memory, the later ones in a
//     global workspace by atomicOr.  Warp 0 itself folds chunk c's kept
//     rows into word c + 1 (one __reduce_or_sync a half), so one barrier a
//     chunk ends the step.
// Rows are banded: a launch pair covers the rows [row0, row0 + band) of
// every image, against all later columns, so that the workspace (a band's
// mask and the removed words) stays bounded whatever A is; the removed
// words in the workspace carry the state from one band to the next.  A
// has no limit.
//
// Bound.  The boxes and ids are a few hundred kilobytes and the IoU
// arithmetic a few million operations at the SSD's shapes, both far below
// a microsecond of the card; what bounds the work is the chain of
// dependent steps, one a kept row, in the image with the most kept rows.
// A step of the walk below is a bit test and a conditional OR of cur,
// three dependent instructions (LOP3 to a predicate, SEL, LOP3), about 13
// cycles a row on the card (bench/nms_variants.py's walk measures it).
//
// Arithmetic.  The IoU follows _iou_matrix's: ix * iy, then
// (area_a + area_b) - inter, union > 0, then inter / union, each rounded
// on its own; where inter is +0 the quotient is +0 for any positive union,
// so the division is skipped there without changing a bit (it cost the
// mask kernel a third of its time on the card).  This source is built with
// --fmad=false, so that nvcc fuses no a * b + c into one FMA: one ulp of
// difference would flip a tie at >= nms_threshold against the plain
// version.
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int NMS_TILE = 64;           // rows a tile and a chunk, bits a word
constexpr int NMS_PARTS = 16;          // scan threads folding one word
constexpr int NMS_PART_ROWS = NMS_TILE / NMS_PARTS;
// stages: the chunk walked, the one folded and the next (staged a chunk
// ahead: two ahead measured no faster on the card)
constexpr int NMS_STAGES = 3;
constexpr int NMS_SMEM = 232448;       // a block's shared memory (sm_90)
constexpr int NMS_SCAN_THREADS = 512;  // the scan's largest block
constexpr int NMS_MAX_BAND_WORDS = 4096;  // the band's removed words (smem)
constexpr unsigned NMS_FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a < b ? b : a; }

template <typename T>
__device__ __forceinline__ T area(T a0, T a1, T a2, T a3) {
  return (a2 - a0) * (a3 - a1);
}

// IoU of box a (its area area_a) and box b (area_b)
template <typename T>
__device__ __forceinline__ T iou(T a0, T a1, T a2, T a3, T area_a,
                                 const T* b, T area_b) {
  const T ix = tmax(T(0), tmin(a2, b[2]) - tmax(a0, b[0]));
  const T iy = tmax(T(0), tmin(a3, b[3]) - tmax(a1, b[1]));
  const T inter = ix * iy;
  const T uni = area_a + area_b - inter;
  return uni > T(0) && inter > T(0) ? inter / uni : T(0);
}

// the upper-triangular (row tile, column tile) pairs before row tile k of
// a band whose first row tile has `a` column tiles from the diagonal on
__device__ __forceinline__ long long tri(long long k, long long a) {
  return k * a - k * (k - 1) / 2;
}

// (a) One block an (image, row tile bi, column tile bj >= bi) of the band,
// row tile by row tile.  mask is (B, words, band), row i of the band at
// i - row0.
template <typename T>
__global__ void __launch_bounds__(NMS_TILE)
nms_mask_kernel(const T* __restrict__ boxes, const T* __restrict__ ids,
                u64* __restrict__ mask, int n, int words, int row0,
                int band, int tiles, T thresh, int force_suppress) {
  extern __shared__ float4 nms_smem[];
  T* const sbox = reinterpret_cast<T*>(nms_smem);   // the column tile's boxes,
  T* const sid = sbox + 4 * NMS_TILE;                // ids
  T* const sarea = sid + NMS_TILE;                   // and areas
  const long long a = words - row0 / NMS_TILE;
  const long long per_img = tri(tiles, a);
  const long long img = blockIdx.x / per_img;
  const long long l = blockIdx.x - img * per_img;
  long long k = (long long)(((2 * a + 1) - sqrt((double)((2 * a + 1)
                            * (2 * a + 1) - 8 * l))) / 2);
  while (k + 1 < tiles && tri(k + 1, a) <= l) ++k;
  while (tri(k, a) > l) --k;
  const int bi = row0 / NMS_TILE + (int)k;
  const int bj = bi + (int)(l - tri(k, a));
  const T* const bx = boxes + img * n * 4;
  const T* const id = ids + img * n;
  const int t = threadIdx.x;
  const int i = bi * NMS_TILE + t, j = bj * NMS_TILE + t;
  // row i's id and box, loaded with the column tile's
  const T idi = i < n ? id[i] : T(-1);
  T a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  if (idi >= T(0)) {
    a0 = bx[4LL * i];
    a1 = bx[4LL * i + 1];
    a2 = bx[4LL * i + 2];
    a3 = bx[4LL * i + 3];
  }
  if (j < n) {
    T b[4];
    for (int q = 0; q < 4; ++q) b[q] = sbox[4 * t + q] = bx[4LL * j + q];
    sid[t] = id[j];
    sarea[t] = area(b[0], b[1], b[2], b[3]);
  } else {
    sid[t] = T(-1);
  }
  __syncthreads();
  if (i >= n) return;
  u64 bits = 0;
  if (idi >= T(0)) {
    u64 match = 0;   // the later columns of row i's class
#pragma unroll
    for (int c = 0; c < NMS_TILE; ++c) {
      const T idj = sid[c];
      if (idj >= T(0) && (force_suppress || idj == idi)) match |= 1ull << c;
    }
    if (bj == bi) match &= t == NMS_TILE - 1 ? 0 : ~0ull << (t + 1);
    const T area_a = area(a0, a1, a2, a3);
    for (; match; match &= match - 1) {
      const int c = __ffsll((long long)match) - 1;
      if (iou(a0, a1, a2, a3, area_a, sbox + 4 * c, sarea[c]) >= thresh)
        bits |= 1ull << c;
    }
  }
  mask[(img * words + bj) * band + (i - row0)] = bits;
}

// cp.async: a copy from global to shared memory that does not wait for the
// data (a barrier does not wait for it either: cp_async_wait does); the
// host pass, which never runs it, and the host emulation copy at once
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(BYTES));
#else
  // the card faults on a misaligned copy; the emulation stops there too
  if ((reinterpret_cast<unsigned long long>(dst)
       | reinterpret_cast<unsigned long long>(src)) % BYTES)
    __builtin_trap();
  for (int i = 0; i < BYTES; ++i)
    static_cast<char*>(dst)[i] = static_cast<const char*>(src)[i];
#endif
}

// this thread's cp.async copies complete
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// the scan's shared memory: s_keep[2], the band's removed words (an even
// count of slots, so that the stages are 16-byte aligned), then
// NMS_STAGES stages of a chunk's ids and mask words (stage words a row)
__host__ __device__ __forceinline__ int nms_band_slots(int band_words) {
  return (band_words + 1) / 2 * 2;
}
int nms_scan_smem(int band_words, int stage) {
  return (int)sizeof(u64) * (2 + nms_band_slots(band_words)
                             + NMS_STAGES * NMS_TILE * (1 + stage));
}

// (b) One block an image: warp 0 walks the chunks of rows [row0, row0 +
// band); the other threads ("folders") stage the next chunk in shared
// memory by cp.async and fold kept rows into the removed words, those of
// the band's chunks in shared memory, the later ones in `removed` (B,
// words), which carries them to the next band.  A chunk's stage holds its
// ids and its rows' mask words from its own word on, `stage` of them (the
// words past those are read from global memory by the fold).
template <typename T>
__global__ void __launch_bounds__(NMS_SCAN_THREADS)
nms_scan_kernel(T* ids, const u64* __restrict__ mask, u64* removed, int n,
                int words, int row0, int band, int stage) {
  extern __shared__ float4 nms_smem[];
  u64* const s_keep = reinterpret_cast<u64*>(nms_smem);  // [2], by parity
  u64* const s_rm = s_keep + 2;              // removed words c0 .. c1 - 1
  const long long img = blockIdx.x;
  T* const id = ids + img * n;
  const u64* const mk = mask + img * words * band;
  u64* const rm = removed + img * words;
  const int c0 = row0 / NMS_TILE;
  const int c1 = words < c0 + band / NMS_TILE ? words
                                              : c0 + band / NMS_TILE;
  u64* const stages = s_rm + nms_band_slots(c1 - c0);
  const int tid = threadIdx.x, lane = tid & 31;
  // folders: NMS_PARTS to a word slot, part p takes rows p, p + NMS_PARTS..
  const int o = tid - 32, folders = (int)blockDim.x - 32;
  const int p = o % NMS_PARTS, slot = o / NMS_PARTS;
  const int slots = folders / NMS_PARTS;
  // chunk c's stage: ids (as T, one u64 slot each), then its rows' words
  // c .. c + stage - 1, word c + k of row r at words_of(c)[64 k + r]
  auto ids_of = [&](int c) {
    return reinterpret_cast<T*>(stages + (c % NMS_STAGES) * NMS_TILE
                                * (1 + stage));
  };
  auto words_of = [&](int c) {
    return stages + (c % NMS_STAGES) * NMS_TILE * (1 + stage) + NMS_TILE;
  };
  // mask word w of absolute row r (r in the band)
  auto mask_at = [&](int r, int w) {
    return mk + (long long)w * band + (r - row0);
  };
  // chunk c's ids and its rows' words c .. c + sw - 1 into its stage by
  // cp.async, two rows of a word a copy (16 bytes, aligned: band and the
  // chunk's first row are even), rows past n -1 and 0
  auto stage_chunk = [&](int c) {
    if (c >= c1) return;
    const int base = c * NMS_TILE, left = n - base;
    const int sw = words - c < stage ? words - c : stage;
    T* const sid = ids_of(c);
    u64* const sw0 = words_of(c);
    for (int r = o; r < NMS_TILE; r += folders) {
      if (r < left)
        cp_async<sizeof(T)>(sid + r, id + base + r);
      else
        sid[r] = T(-1);
    }
    for (int e = o; e < NMS_TILE / 2 * sw; e += folders) {
      const int k = e / (NMS_TILE / 2), r = 2 * (e % (NMS_TILE / 2));
      u64* const dst = sw0 + k * NMS_TILE + r;
      if (r + 1 < left) {
        cp_async<16>(dst, mask_at(base + r, c + k));
      } else {
        if (r < left)
          cp_async<8>(dst, mask_at(base + r, c + k));
        else
          dst[0] = 0;
        dst[1] = 0;
      }
    }
  };
  // the kept rows `keep` of chunk c into the removed words from w0 on: slot
  // s takes w0 + s, w0 + s + slots, ... (nk is the same in every thread),
  // the NMS_PARTS lanes of a slot ORed together by shuffles
  auto fold = [&](u64 keep, int c, int w0) {
    const int base = c * NMS_TILE;
    const u64* const sw0 = words_of(c);
    const int nk = (words - w0 + slots - 1) / slots;
    for (int k = 0; k < nk; ++k) {
      const int w = w0 + slot + k * slots;
      u64 acc = 0;
      if (w < words) {
#pragma unroll
        for (int q = 0; q < NMS_PART_ROWS; ++q) {
          const int r = p + NMS_PARTS * q;
          if ((keep >> r) & 1)
            acc |= w - c < stage ? sw0[(w - c) * NMS_TILE + r]
                                 : *mask_at(base + r, w);
        }
      }
#pragma unroll
      for (int m = 1; m < NMS_PARTS; m <<= 1)
        acc |= __shfl_xor_sync(NMS_FULL, acc, m);
      if (p == 0 && acc) {
        if (w < c1)
          s_rm[w - c0] |= acc;
        else
          atomicOr(rm + w, acc);
      }
    }
  };

  u64 part = 0;   // warp 0: the last chunk's kept rows at its next word
  if (tid >= 32) {
    stage_chunk(c0);
    for (int w = c0 + o; w < c1; w += folders)
      s_rm[w - c0] = c0 == 0 ? 0 : rm[w];
    if (c0 == 0)
      for (int w = c1 + o; w < words; w += folders) rm[w] = 0;
  }
  for (int c = c0; c < c1; ++c) {
    cp_async_wait();   // chunk c's stage (this thread's copies)
    __syncthreads();   // and everyone's; the last step's results
    const int base = c * NMS_TILE;
    if (tid < 32) {
      const T* const sid = ids_of(c);
      const u64* const sw0 = words_of(c);
      const T il = sid[lane], ih = sid[lane + 32];
      const u64 valid = (u64)__ballot_sync(NMS_FULL, il >= T(0))
          | (u64)__ballot_sync(NMS_FULL, ih >= T(0)) << 32;
      u64 cur = s_rm[c - c0] | part | ~valid;
      const u64 dl = sw0[lane], dh = sw0[32 + lane];
#pragma unroll
      for (int r = 0; r < NMS_TILE; ++r) {   // row r's diagonal word
        const u64 w = __shfl_sync(NMS_FULL, r < 32 ? dl : dh, r & 31);
        if (!((cur >> r) & 1)) cur |= w;
      }
      const u64 keep = ~cur;
      if (il >= T(0) && !((keep >> lane) & 1)) id[base + lane] = T(-1);
      if (ih >= T(0) && !((keep >> (32 + lane)) & 1))
        id[base + 32 + lane] = T(-1);
      if (lane == 0) s_keep[c & 1] = keep;
      u64 mw = 0;   // the kept rows' words c + 1
      if (c + 1 < words) {
        if ((keep >> lane) & 1) mw |= sw0[NMS_TILE + lane];
        if ((keep >> (32 + lane)) & 1) mw |= sw0[NMS_TILE + 32 + lane];
      }
      part = (u64)__reduce_or_sync(NMS_FULL, (unsigned)mw)
          | (u64)__reduce_or_sync(NMS_FULL, (unsigned)(mw >> 32)) << 32;
    } else {
      stage_chunk(c + 1);
      if (c > c0)   // chunk c - 1's kept rows into the words >= c + 1
        fold(s_keep[(c - 1) & 1], c - 1, c + 1);
    }
  }

  // the last chunk's kept rows into the words >= c1, for the next band
  __syncthreads();
  if (c1 < words) {
    if (tid == 0) {
      if (part) atomicOr(rm + c1, part);
    } else if (tid >= 32) {
      fold(s_keep[(c1 - 1) & 1], c1 - 1, c1 + 1);
    }
  }
}

int nms_words(int n) { return (n + NMS_TILE - 1) / NMS_TILE; }

bool bad_band(int b, int n, int row0, int band) {
  return b < 1 || n < 1 || band < NMS_TILE || band % NMS_TILE
      || band / NMS_TILE > NMS_MAX_BAND_WORDS || row0 < 0
      || row0 % NMS_TILE || row0 >= n;
}

template <typename T>
int launch_mask(const void* boxes, const void* ids, void* mask, int b,
                int n, int row0, int band, double thresh,
                int force_suppress, cudaStream_t s) {
  const int words = nms_words(n);
  const int rows = band < words * NMS_TILE - row0 ? band
                                                  : words * NMS_TILE - row0;
  const long long tiles = rows / NMS_TILE, a = words - row0 / NMS_TILE;
  const long long blocks = b * (tiles * a - tiles * (tiles - 1) / 2);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem = 6 * NMS_TILE * sizeof(T);
  nms_mask_kernel<T><<<(unsigned)blocks, NMS_TILE, smem, s>>>(
      static_cast<const T*>(boxes), static_cast<const T*>(ids),
      static_cast<u64*>(mask), n, words, row0, band, (int)tiles, (T)thresh,
      force_suppress);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scan(void* ids, const void* mask, void* removed, int b, int n,
                int row0, int band, cudaStream_t s) {
  const int words = nms_words(n), c0 = row0 / NMS_TILE;
  const int c1 = words < c0 + band / NMS_TILE ? words
                                              : c0 + band / NMS_TILE;
  // the block: NMS_PARTS threads a word of the band's first fold, and warp
  // 0, up to NMS_SCAN_THREADS
  const int nw = words - c0 - 1;
  const int f = ((nw < 1 ? 1 : nw) * NMS_PARTS + 31) / 32 * 32;
  const int fmax = NMS_SCAN_THREADS - 32;
  const int threads = 32 + (f < fmax ? f : fmax);
  // a stage holds a row's words from the band's first on, as many as the
  // shared memory beside the band's removed words has room for
  const int most = (NMS_SMEM - nms_scan_smem(c1 - c0, 0))
      / ((int)sizeof(u64) * NMS_STAGES * NMS_TILE);
  const int stage = words - c0 < most ? words - c0 : most;
  if (stage < 2 && stage < words - c0) return (int)cudaErrorInvalidValue;
  const int smem = nms_scan_smem(c1 - c0, stage);
  cudaError_t err = cudaFuncSetAttribute(
      nms_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<T><<<b, threads, smem, s>>>(
      static_cast<T*>(ids), static_cast<const u64*>(mask),
      static_cast<u64*>(removed), n, words, row0, band, stage);
  return (int)cudaGetLastError();
}

}  // namespace

// The mask of the rows [row0, row0 + band) of b images of n rows: boxes
// (b, n, 4) and ids (b, n), contiguous, float64 when f64 else float32; mask
// (b, ceil(n / 64), band) 64-bit words.  row0 and band are multiples of
// 64, band at most 64 * 4096.  thresh is rounded to the boxes' type, as the
// JAX package rounds a Python float against a float32 array.  Returns
// cudaGetLastError() after the launch.
extern "C" int multibox_nms_mask_launch(const void* boxes, const void* ids,
                                        void* mask, int b, int n, int row0,
                                        int band, double thresh,
                                        int force_suppress, int f64,
                                        void* stream) {
  if (bad_band(b, n, row0, band)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_mask<double>(boxes, ids, mask, b, n, row0, band,
                                   thresh, force_suppress, s)
             : launch_mask<float>(boxes, ids, mask, b, n, row0, band,
                                  thresh, force_suppress, s);
}

// The scan over the same band's mask, after multibox_nms_mask_launch on the
// same stream; removed (b, ceil(n / 64)) 64-bit words, zeroed by the band
// at row0 = 0 and carried to the next band.  Bands are scanned in order.
// The block is warp 0 and NMS_PARTS (16) threads a word of the band's
// first fold, at most NMS_SCAN_THREADS (512); a stage holds as many words
// of a row as the shared memory left beside the band's removed words has
// room for (all of a row's words up to 129-150 words, by the band's size;
// the fold reads the words past them from global memory).
extern "C" int multibox_nms_scan_launch(void* ids, const void* mask,
                                        void* removed, int b, int n,
                                        int row0, int band, int f64,
                                        void* stream) {
  if (bad_band(b, n, row0, band)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_scan<double>(ids, mask, removed, b, n, row0, band, s)
             : launch_scan<float>(ids, mask, removed, b, n, row0, band, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
