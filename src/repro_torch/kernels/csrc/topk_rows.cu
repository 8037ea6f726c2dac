// Per-row magnitude top-k for Hopper (sm_90a): the port of the Pallas TPU
// kernel `_topk_kernel` / `topk_rows_pallas` (src/repro/kernels/
// topk_compress.py:29 and :47).
//
// What it computes, per row of x [rows, cols]: the k columns of largest
// |x| in descending order, ties to the lower column, NaN ranking above
// +inf (as jnp.argmax and a stable descending torch.sort rank it), -0.0
// equal to 0, a denormal magnitude equal to 0 (XLA flushes denormals, so
// the JAX package ranks them so); the signed values in x's dtype, bits
// kept, and the int32 columns.
//
// Design: a radix select, one block of 256 threads per row.
//   keys       the row is read once from device memory and each |x| is
//              stored in shared memory as its uint32 bit pattern, which
//              orders non-negative floats; every NaN becomes 0xffffffff,
//              every denormal 0.
//   threshold  the k-th largest key, found by four passes of 8-bit digit
//              histograms (most significant first) in shared memory.  A
//              warp adds each digit once with __match_any_sync, so a hot
//              digit (most magnitudes share their top byte) is one atomic
//              a warp, not 32.  Warp 0 suffix-sums the 256 bins with
//              shuffles to pick the digit and the rank left within it.
//   compaction every key above the threshold is a candidate, and so are
//              the lowest-column ties at the threshold until there are k.
//              The tie ranks come from an ordered compaction: each warp
//              owns a contiguous column range, counts its ties, one
//              prefix over the 8 warp counts gives each warp its base,
//              and __ballot_sync prefixes rank the ties in column order.
//              An atomic counter alone would lose that order.
//   output     the k candidates, packed as (key << 32 | ~column), are
//              bitonic-sorted descending -- key descending, column
//              ascending -- by one warp when k <= 64, else by the block;
//              the values are copied from x in its own dtype.
//
// What bounds it on this card: reading rows*cols*bytes once (about 30 us
// for the 6144 x 4096 f32 gradient matrix at 3.35 TB/s); the passes run
// over shared memory, so the per-row work is a few thousand cycles
// spread over 8 blocks an SM.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libtopk_rows.so topk_rows.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNaNKey = 0xffffffffu;
constexpr uint32_t kFltMinBits = 0x00800000u;  // smallest normal f32

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// |v| as an ordered uint32 key: the bits of |v|, NaN above +inf, a
// denormal 0
template <typename T>
__device__ __forceinline__ uint32_t mag_key(T v) {
  const uint32_t u = __float_as_uint(to_f32(v)) & 0x7fffffffu;
  return u > 0x7f800000u ? kNaNKey : (u < kFltMinBits ? 0u : u);
}

// Bitonic sort of c[0, p) descending, p a power of two; `stride_t`
// threads starting at `t` take part, `sync` orders the stages.
template <typename Sync>
__device__ void bitonic_desc(uint64_t* c, int p, int t, int stride_t,
                             Sync sync) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < p; i += stride_t) {
        const int j = i ^ stride;
        if (j > i) {
          const uint64_t a = c[i], b = c[j];
          const bool desc = (i & size) == 0;
          if (desc ? (a < b) : (a > b)) {
            c[i] = b;
            c[j] = a;
          }
        }
      }
      sync();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_rows_kernel(const T* __restrict__ x, int cols, int k, int p,
                 T* __restrict__ vals, int32_t* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* cand = reinterpret_cast<uint64_t*>(smem);  // [p]
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem + (size_t)p * 8);
  __shared__ int hist[256];
  __shared__ int warp_ties[kWarps];
  __shared__ int s_digit, s_rank, s_slot;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xr = x + (size_t)blockIdx.x * cols;
  for (int c = tid; c < cols; c += kThreads) keys[c] = mag_key(xr[c]);

  // --- threshold: the k-th largest key, 8 bits a pass -----------------
  uint32_t prefix = 0, mask = 0;
  int rank = k;  // rank of the threshold among keys matching `prefix`
  const int cols_pad = (cols + kThreads - 1) / kThreads * kThreads;
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist[tid] = 0;  // kThreads == 256 bins
    __syncthreads();
    for (int c = tid; c < cols_pad; c += kThreads) {
      const uint32_t key = c < cols ? keys[c] : 0;
      const bool match = c < cols && (key & mask) == prefix;
      const int d = match ? (int)((key >> shift) & 0xffu) : 256;
      const unsigned peers = __match_any_sync(kFull, d);
      if (match && lane == __ffs(peers) - 1)
        atomicAdd(&hist[d], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {  // lane l holds bins 8l .. 8l+7
      int h[8], s = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) s += h[b] = hist[lane * 8 + b];
      int suf = s;  // sum over lanes >= lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_down_sync(kFull, suf, off);
        if (lane + off < 32) suf += t;
      }
      int above = suf - s;  // keys in higher digits
      if (above < rank && rank <= suf) {
#pragma unroll
        for (int b = 7; b >= 0; --b) {
          if (above + h[b] >= rank) {
            s_digit = lane * 8 + b;
            s_rank = rank - above;
            break;
          }
          above += h[b];
        }
      }
    }
    __syncthreads();
    prefix |= (uint32_t)s_digit << shift;
    mask |= 0xffu << shift;
    rank = s_rank;
  }
  const uint32_t thr = prefix;  // take every key > thr and `rank` ties

  // --- ordered compaction ----------------------------------------------
  const int seg = (cols + kWarps * 32 - 1) / (kWarps * 32) * 32;
  const int lo = warp * seg, hi = min(cols, lo + seg);
  int ties = 0;
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int c = c0 + lane;
    ties += __popc(__ballot_sync(kFull, c < hi && keys[c] == thr));
  }
  if (lane == 0) warp_ties[warp] = ties;
  if (tid == 0) s_slot = 0;
  __syncthreads();
  int run = 0;
  for (int w = 0; w < warp; ++w) run += warp_ties[w];
  const unsigned lt = (1u << lane) - 1;
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int c = c0 + lane;
    const uint32_t key = c < hi ? keys[c] : 0;
    const bool eq = c < hi && key == thr;
    const unsigned eqm = __ballot_sync(kFull, eq);
    const bool take = (c < hi && key > thr) ||
                      (eq && run + __popc(eqm & lt) < rank);
    run += __popc(eqm);
    if (take)
      cand[atomicAdd(&s_slot, 1)] = ((uint64_t)key << 32) | (uint32_t)~c;
  }
  for (int j = k + tid; j < p; j += kThreads) cand[j] = 0;  // sorts last
  __syncthreads();

  // --- sort (key desc, column asc) and write ---------------------------
  if (p <= 64) {
    if (warp == 0) bitonic_desc(cand, p, lane, 32, [] { __syncwarp(); });
  } else {
    bitonic_desc(cand, p, tid, kThreads, [] { __syncthreads(); });
  }
  __syncthreads();
  for (int j = tid; j < k; j += kThreads) {
    const int c = (int)~(uint32_t)cand[j];
    vals[(size_t)blockIdx.x * k + j] = xr[c];
    idx[(size_t)blockIdx.x * k + j] = c;
  }
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

size_t smem_bytes(int cols, int k) {
  return (size_t)pow2_at_least(k) * 8 + (size_t)cols * 4;
}

template <typename T>
int launch(const void* x, int rows, int cols, int k, void* vals, void* idx,
           cudaStream_t stream) {
  const size_t dyn = smem_bytes(cols, k);
  auto kern = &topk_rows_kernel<T>;
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<rows, kThreads, dyn, stream>>>(
      static_cast<const T*>(x), cols, k, pow2_at_least(k),
      static_cast<T*>(vals), static_cast<int32_t*>(idx));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the per-row top-k on `stream`.  x [rows, cols] contiguous,
// 1 <= k <= cols; outputs vals [rows, k] in x's dtype, idx [rows, k]
// int32.  Returns cudaGetLastError() after the launch (0 = ok).
int topk_rows_launch(const void* x, int rows, int cols, int k, int dtype,
                     void* vals, void* idx, void* stream) {
  if (rows < 1 || cols < 1 || k < 1 || k > cols)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, rows, cols, k, vals, idx, s);
    case kBF16: return launch<__nv_bfloat16>(x, rows, cols, k, vals, idx, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
