// Greedy non-maximum suppression of MultiBoxDetection for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs this loop as XLA, a
// lax.fori_loop over the score-sorted boxes with a lax.cond inside
// (mxnet_tpu/ops/contrib.py::_greedy_nms), which XLA keeps on the device as
// one loop.  Eager PyTorch would spend about five launches a box on it, and
// a host read to test each box, so the port runs it as this one launch, as
// MXNet's own multibox_detection.cu did.
//
// Contract (that of _greedy_nms, batched): boxes (B, A, 4) corner boxes and
// ids (B, A) class ids, each image's rows sorted by descending score, a
// suppressed or invalid row carrying id -1.  For i = 0, 1, ..., A-1 in
// turn, if ids[i] >= 0, every row j > i still alive (ids[j] >= 0), of the
// same class (of any class under force_suppress), whose IoU with box i is
// >= nms_threshold gets ids[j] = -1.  ids is updated in place.  float32 or
// float64, one type for both arrays.
//
// Design.  One block per image; thread t takes the rows j = i+1+t,
// i+1+t+blockDim.x, ... of step i.  The suppression state is the id column
// itself, in global memory: a step writes only rows j > i, each row by one
// thread, and __syncthreads() ends every step that wrote, which makes its
// writes visible to the whole block, so A has no limit.  A step whose box
// is already suppressed writes nothing, and every thread reads the same
// ids[i] (its last write was before an earlier barrier), so the block
// skips it together without a barrier.  The steps that run are the rows
// kept in the output.
//
// Bound.  The boxes and ids are a few hundred kilobytes and the IoU
// arithmetic a few million operations at the SSD's shapes, both far below
// a microsecond of the card; what bounds the kernel is the chain of
// dependent steps, one block-wide barrier each, in the image with the most
// kept rows.
//
// Arithmetic.  The IoU follows _iou_matrix's: ix * iy, then
// (area_a + area_b) - inter, union > 0, then inter / union, each rounded
// on its own.  This source is built with --fmad=false, so that nvcc fuses
// no a * b + c into one FMA: one ulp of difference would flip a tie at
// >= nms_threshold against the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int NMS_THREADS = 256;

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a < b ? b : a; }

template <typename T>
__device__ __forceinline__ T iou(T a0, T a1, T a2, T a3, const T* b) {
  const T ix = tmax(T(0), tmin(a2, b[2]) - tmax(a0, b[0]));
  const T iy = tmax(T(0), tmin(a3, b[3]) - tmax(a1, b[1]));
  const T inter = ix * iy;
  const T area_a = (a2 - a0) * (a3 - a1);
  const T area_b = (b[2] - b[0]) * (b[3] - b[1]);
  const T uni = area_a + area_b - inter;
  return uni > T(0) ? inter / uni : T(0);
}

template <typename T>
__global__ void __launch_bounds__(NMS_THREADS)
multibox_nms_kernel(const T* __restrict__ boxes, T* ids, int n, T thresh,
                    int force_suppress) {
  const T* bx = boxes + (size_t)blockIdx.x * n * 4;
  T* id = ids + (size_t)blockIdx.x * n;
  for (int i = 0; i < n; ++i) {
    const T idi = id[i];
    if (idi < T(0)) continue;
    const T a0 = bx[4 * i], a1 = bx[4 * i + 1], a2 = bx[4 * i + 2],
            a3 = bx[4 * i + 3];
    for (int j = i + 1 + (int)threadIdx.x; j < n; j += NMS_THREADS) {
      const T idj = id[j];
      if (idj < T(0) || (!force_suppress && idj != idi)) continue;
      if (iou(a0, a1, a2, a3, bx + 4 * (size_t)j) >= thresh) id[j] = T(-1);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* boxes, void* ids, int b, int n, double thresh,
           int force_suppress, cudaStream_t s) {
  multibox_nms_kernel<T><<<b, NMS_THREADS, 0, s>>>(
      static_cast<const T*>(boxes), static_cast<T*>(ids), n, (T)thresh,
      force_suppress);
  return (int)cudaGetLastError();
}

}  // namespace

// boxes (b, n, 4) and ids (b, n), contiguous, float64 when f64 else
// float32; thresh is rounded to the boxes' type, as the JAX package rounds
// a Python float against a float32 array.  Returns cudaGetLastError()
// after the launch.
extern "C" int multibox_nms_launch(const void* boxes, void* ids, int b,
                                   int n, double thresh, int force_suppress,
                                   int f64, void* stream) {
  if (b < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(boxes, ids, b, n, thresh, force_suppress, s)
             : launch<float>(boxes, ids, b, n, thresh, force_suppress, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
