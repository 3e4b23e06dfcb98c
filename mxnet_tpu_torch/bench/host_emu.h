// Host emulation of the CUDA subset that the port's flash-attention and
// NormConv kernels use, so that their source compiles with a host C++20
// compiler and runs on the CPU (host_emu.py).  A launch runs its blocks
// one after another (x fastest, then y, then z) on one std::thread per
// CUDA thread, and __syncthreads is a barrier.  A warp shuffle
// (__shfl_xor_sync, __shfl_sync; full mask, blocks of whole warps) posts
// each lane's value to a slot of its warp, waits at the warp's barrier,
// reads its partner's slot and waits again before the slots are reused;
// __ballot_sync and __reduce_or_sync read all 32 slots the same way.
// Atomics are std::atomic_ref operations and __threadfence a sequentially
// consistent fence; as blocks run in order, the last of a tile's split-K
// slices is always the block with the highest z.
// Dynamic shared memory is one static buffer, filled with NaN bytes before
// each block so that a read of an unwritten element shows in the output.
// Float arithmetic is the host's: fmaf is a fused multiply-add as on the
// card, but the compiler contracts no other a * b + c (-ffp-contract=off),
// where nvcc may, so results agree with the card's to rounding, not bits.
#pragma once
#include <atomic>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <math.h>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)

struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
template <typename T> inline T __ldg(const T* p) { return *p; }
template <typename T> inline T __ldcg(const T* p) { return *p; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
template <typename T> inline T atomicAdd(T* p, T v) {
  return std::atomic_ref<T>(*p).fetch_add(v);
}
template <typename T> inline T atomicOr(T* p, T v) {
  return std::atomic_ref<T>(*p).fetch_or(v);
}
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}

struct __nv_bfloat16 { uint16_t bits; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {   // finite inputs
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return {(uint16_t)((u + 0x7fff + ((u >> 16) & 1)) >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) {
  return h.bits;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return {__bfloat162float(h.x), __bfloat162float(h.y)};
}

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
// the emulated card has 4 SMs, so that small test grids fall on both sides
// of a kernel's choice by grid size
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 4;
  return cudaSuccess;
}
constexpr size_t EMU_SMEM = 232448;   // an H100 block's shared-memory limit
inline int emu_error = 0;
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline cudaError_t cudaGetLastError() {
  const int e = emu_error;
  emu_error = 0;
  return e;
}
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  return bytes > (int)EMU_SMEM ? cudaErrorInvalidValue : cudaSuccess;
}

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
inline std::barrier<>* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
alignas(16) inline float4 emu_smem[EMU_SMEM / 16];

inline std::deque<std::barrier<>>* emu_warp_barriers = nullptr;
inline uint64_t emu_shfl_slots[1024];
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) <= sizeof(uint64_t), "shuffle of a wide type");
  const unsigned t = threadIdx.x, base = t & ~31u;
  std::barrier<>& bar = (*emu_warp_barriers)[t / 32];
  std::memcpy(&emu_shfl_slots[t], &v, sizeof(T));
  bar.arrive_and_wait();
  T r;
  std::memcpy(&r, &emu_shfl_slots[base + ((t - base) ^ (unsigned)lane_mask)],
              sizeof(T));
  bar.arrive_and_wait();
  return r;
}

template <typename T>
inline T __shfl_sync(unsigned, T v, int src_lane) {
  static_assert(sizeof(T) <= sizeof(uint64_t), "shuffle of a wide type");
  const unsigned t = threadIdx.x, base = t & ~31u;
  std::barrier<>& bar = (*emu_warp_barriers)[t / 32];
  std::memcpy(&emu_shfl_slots[t], &v, sizeof(T));
  bar.arrive_and_wait();
  T r;
  std::memcpy(&r, &emu_shfl_slots[base + ((unsigned)src_lane & 31u)],
              sizeof(T));
  bar.arrive_and_wait();
  return r;
}
// the OR of v over the 32 lanes of the calling thread's warp
inline unsigned emu_warp_or(unsigned v) {
  const unsigned t = threadIdx.x, base = t & ~31u;
  std::barrier<>& bar = (*emu_warp_barriers)[t / 32];
  emu_shfl_slots[t] = v;
  bar.arrive_and_wait();
  unsigned r = 0;
  for (unsigned l = 0; l < 32; ++l) r |= (unsigned)emu_shfl_slots[base + l];
  bar.arrive_and_wait();
  return r;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  return emu_warp_or(pred ? 1u << (threadIdx.x & 31u) : 0u);
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return emu_warp_or(v);
}
inline int __ffsll(long long x) { return __builtin_ffsll(x); }

// kernel<<<grid, threads, smem, stream>>>(args...) is rewritten into
// emu_launch(kernel, grid, threads, smem, stream, args...)
template <typename K, typename... A>
inline void emu_launch(K kernel, dim3 grid, unsigned threads, size_t smem,
                       cudaStream_t, A... args) {
  if (smem > EMU_SMEM || threads > 1024) {
    emu_error = cudaErrorInvalidValue;
    return;
  }
  gridDim = grid;
  blockDim = dim3(threads);
  std::barrier<> bar(threads);
  emu_barrier = &bar;
  std::deque<std::barrier<>> warps;
  for (unsigned w = 0; w < threads; w += 32)
    warps.emplace_back(threads - w < 32 ? threads - w : 32);
  emu_warp_barriers = &warps;
  // one std::thread per CUDA thread for the whole launch, walking the
  // blocks in order; thread 0 refills shared memory between two blocks
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      threadIdx = dim3(t);
      for (unsigned bz = 0; bz < grid.z; ++bz)
        for (unsigned by = 0; by < grid.y; ++by)
          for (unsigned bx = 0; bx < grid.x; ++bx) {
            if (t == 0) std::memset(emu_smem, 0xff, smem);
            bar.arrive_and_wait();
            blockIdx = dim3(bx, by, bz);
            kernel(args...);
            bar.arrive_and_wait();
          }
    });
  for (auto& th : pool) th.join();
}
// a launch with a dim3 block (an Rtc launcher's): one-dimensional blocks
template <typename K, typename... A>
inline void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem,
                       cudaStream_t stream, A... args) {
  if (block.y != 1 || block.z != 1) {
    emu_error = cudaErrorInvalidValue;
    return;
  }
  emu_launch(kernel, grid, block.x, smem, stream, args...);
}
