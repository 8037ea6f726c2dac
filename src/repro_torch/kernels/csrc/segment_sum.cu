// In-order segmented sum for Hopper (sm_90a): the BPE's sum, added in
// ascending index order on the card.
//
// What it computes: out[s, l] = sum of values[i, l] over the i with
// ids[i] == s, added in ascending i from 0 with one rounding per add --
// what ``jax.ops.segment_sum`` and ``index_add_`` on a 1-D CPU tensor
// compute.  ``index_add_`` on a CUDA tensor adds with atomics in no fixed
// order, so a cascade on the card would differ from the CPU's (and the
// JAX package's) in the last bits of its f32 sums.  This kernel replaces
// no TPU kernel: on the TPU the sum is XLA's ``segment_sum``.
//
// Design.  The entries of each id form one contiguous run (the wrapper
// sorts the ids stably when the caller does not say so).  One thread per
// element; the thread at the start of a run walks the run and stores its
// sum once.  Empty segments keep the zeros the wrapper wrote.  A run of
// an id outside [0, num_segments) is dropped without a walk: the BPE
// gives its EMPTY_KEY pads id -1 that way.
//
// What bounds it on this card: the bytes of ids and values read once and
// the sums written once (bandwidth), as long as runs are short -- the
// BPE's runs are the duplicates of one key in an eviction stream.  A
// long run is a dependent chain of adds in one thread.
//
// Arithmetic: f32 and f64 add with __fadd_rn / __dadd_rn (no
// contraction); bf16 and f16 add in f32 and round to nearest even after
// every add; int32 and int64 sums wrap.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libsegment_sum.so segment_sum.cu

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum DType : int { kF32 = 0, kBF16 = 1, kI32 = 2, kF16 = 3, kF64 = 4,
                   kI64 = 5 };

template <typename T>
struct Acc;

template <>
struct Acc<float> {
  using R = float;
  __device__ static R add(R a, float v) { return __fadd_rn(a, v); }
  __device__ static float out(R a) { return a; }
};

template <>
struct Acc<double> {
  using R = double;
  __device__ static R add(R a, double v) { return __dadd_rn(a, v); }
  __device__ static double out(R a) { return a; }
};

template <>
struct Acc<__nv_bfloat16> {
  using R = __nv_bfloat16;
  __device__ static R add(R a, __nv_bfloat16 v) {
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(a), __bfloat162float(v)));
  }
  __device__ static __nv_bfloat16 out(R a) { return a; }
};

template <>
struct Acc<__half> {
  using R = __half;
  __device__ static R add(R a, __half v) {
    return __float2half_rn(__fadd_rn(__half2float(a), __half2float(v)));
  }
  __device__ static __half out(R a) { return a; }
};

template <>
struct Acc<int32_t> {
  using R = int32_t;
  __device__ static R add(R a, int32_t v) {
    return (int32_t)((uint32_t)a + (uint32_t)v);
  }
  __device__ static int32_t out(R a) { return a; }
};

template <>
struct Acc<int64_t> {
  using R = int64_t;
  __device__ static R add(R a, int64_t v) {
    return (int64_t)((uint64_t)a + (uint64_t)v);
  }
  __device__ static int64_t out(R a) { return a; }
};

template <typename T>
__device__ T zero();
template <> __device__ float zero<float>() { return 0.0f; }
template <> __device__ double zero<double>() { return 0.0; }
template <> __device__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}
template <> __device__ __half zero<__half>() { return __float2half_rn(0.0f); }
template <> __device__ int32_t zero<int32_t>() { return 0; }
template <> __device__ int64_t zero<int64_t>() { return 0; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ vals, const int64_t* __restrict__ ids,
                   int64_t n, int lanes, int64_t num_segments,
                   T* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t s = ids[i];
  if (i > 0 && ids[i - 1] == s) return;  // not the start of a run
  if (s < 0 || s >= num_segments) return;
  int64_t end = i + 1;
  while (end < n && ids[end] == s) ++end;
  for (int l = 0; l < lanes; ++l) {
    typename Acc<T>::R acc = zero<T>();
    for (int64_t j = i; j < end; ++j)
      acc = Acc<T>::add(acc, vals[j * lanes + l]);
    out[s * lanes + l] = Acc<T>::out(acc);
  }
}

template <typename T>
int launch(const void* vals, const void* ids, int64_t n, int lanes,
           int64_t num_segments, void* out, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  segment_sum_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const int64_t*>(ids), n, lanes,
      num_segments, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one in-order segmented sum on `stream`.  vals [n, lanes], ids
// [n] int64 (each id one contiguous run), out [num_segments, lanes]
// holding zeros.
// Returns cudaGetLastError() after the launch (0 = ok).
int segment_sum_launch(const void* vals, const void* ids, int64_t n, int lanes,
                       int64_t num_segments, int dtype, void* out,
                       void* stream) {
  if (n < 0 || lanes < 1 || num_segments < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(vals, ids, n, lanes, num_segments, out, s);
    case kBF16:
      return launch<__nv_bfloat16>(vals, ids, n, lanes, num_segments, out, s);
    case kI32:
      return launch<int32_t>(vals, ids, n, lanes, num_segments, out, s);
    case kF16: return launch<__half>(vals, ids, n, lanes, num_segments, out, s);
    case kF64: return launch<double>(vals, ids, n, lanes, num_segments, out, s);
    case kI64:
      return launch<int64_t>(vals, ids, n, lanes, num_segments, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
