// FPE hash-combine engine for Hopper (sm_90a): the port of the Pallas TPU
// kernel `_fpe_kernel` / `fpe_aggregate_pallas` (src/repro/kernels/
// kv_aggregate.py:62 and :151), bit for bit the sequential scan
// `_fpe_scan` of src/repro/core/kvagg.py.
//
// What it computes, per streamed (key, value[lanes]) pair, in stream order:
//   hash the key to a bucket and probe all `ways` of its row;
//   hit            -> combine every value lane in place;
//   miss, free way -> insert at the first empty way;
//   miss, full row -> evict way 0 to this pair's slot of the eviction
//                     stream, shift the row left, insert at the last way.
// EMPTY_KEY (-1) pads are skipped and leave (EMPTY_KEY, 0) in their slot.
// The table starts empty or from a table passed in (resume), and is
// written out once at the end (the end-of-task flush).
//
// Design.  One thread block per independent table; this slice launches
// one table per call (grid of 1).  The TPU's sequential grid axis becomes
// the loop inside the block: warp 0 walks the whole stream in order,
// which `exact_stream=True` requires.  Lane w of the warp holds way w
// (strided for ways > 32): one __ballot_sync gives the hit and empty
// masks, __ffs the first empty way.  The table lives in dynamic shared
// memory — the switch-SRAM analogue — when n_buckets*ways*(4 +
// bytes(value)*lanes) fits the opt-in limit (227 KB on H100), else in
// the output table buffer in global memory.  Both are this kernel.
//
// What bounds it on this card: a dependent chain of one shared-memory
// probe-and-update per element, not bandwidth — n*(8+8*lanes) bytes
// moves in microseconds at 3.35 TB/s, while each element waits for the
// previous one's row update.  The design accepts that for now; a
// multi-table or warp-specialised design is later work.
//
// Arithmetic mirrors repro_torch/core/aggops.py per op: bf16 combines in
// f32 and rounds once with __float2bfloat16_rn (round to nearest even);
// int32 sums wrap; logsumexp is m + log1p(exp(-|a-b|)) with equal
// infinities passed through, as torch.logaddexp does.  count and mean
// are sums over their carried lanes.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfpe_aggregate.so fpe_aggregate.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kEmpty = -1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLanes = 4;
constexpr int kThreads = 256;

enum Op : int { kSum = 0, kMax = 1, kMin = 2, kLogSumExp = 3 };
enum DType : int { kF32 = 0, kBF16 = 1, kI32 = 2 };

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  using R = float;  // register type the combine runs in
  __device__ static R to(float v) { return v; }
  __device__ static float from(R v) { return v; }
};

template <>
struct Traits<__nv_bfloat16> {
  using R = float;
  __device__ static R to(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from(R v) { return __float2bfloat16_rn(v); }
};

template <>
struct Traits<int32_t> {
  using R = int32_t;
  __device__ static R to(int32_t v) { return v; }
  __device__ static int32_t from(R v) { return v; }
};

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if (OP == kSum) return __fadd_rn(a, b);
  if (OP == kMax) return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? b : a);
  if (OP == kMin) return (a != a || b != b) ? __int_as_float(0x7fc00000) : (b < a ? b : a);
  if (isinf(a) && a == b) return a;
  const float m = a < b ? b : a;
  return m + log1pf(expf(-fabsf(a - b)));
}

template <int OP>
__device__ __forceinline__ int32_t combine(int32_t a, int32_t b) {
  if (OP == kSum) return (int32_t)((uint32_t)a + (uint32_t)b);
  if (OP == kMax) return a < b ? b : a;
  return b < a ? b : a;  // kMin (logsumexp is never instantiated for int32)
}

// aggops.hash_key in uint32_t arithmetic
__device__ __forceinline__ uint32_t fpe_hash(int32_t k, uint32_t n_buckets) {
  uint32_t h = (uint32_t)k * 0x9E3779B1u;
  h ^= h >> 15;
  return h % n_buckets;
}

template <typename R, int L>
__device__ __forceinline__ R pick(const R (&v)[L], int l) {
  R out = v[0];
#pragma unroll
  for (int j = 1; j < L; ++j)
    if (l == j) out = v[j];
  return out;
}

// Warp 0 walks the stream.  Keys and values are loaded 32 pairs at a
// time (one per lane, coalesced).  One __ballot_sync marks the real pairs
// among them, and the warp visits only those, in order: an EMPTY_KEY pad
// costs nothing past that ballot.  Each real pair's key and its value
// lanes are broadcast with __shfl_sync.  Each lane buffers the eviction
// of "its" pair and stores it after the 32 pairs, so the eviction stream
// leaves coalesced too.  L is the compiled lane count: 1, 2, or kMaxLanes
// with the runtime count `lanes_rt` <= L.
template <int OP, typename T, int L>
__device__ void scan_warp(const int32_t* __restrict__ keys,
                          const T* __restrict__ vals, int n, int lanes_rt,
                          uint32_t n_buckets, int ways, int32_t* tk, T* tv,
                          int32_t* __restrict__ ev_k, T* __restrict__ ev_v) {
  using Tr = Traits<T>;
  using R = typename Tr::R;
  const int lanes = L < kMaxLanes ? L : lanes_rt;
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int my_i = i0 + lane;
    const bool in = my_i < n;
    const int32_t my_k = in ? keys[my_i] : kEmpty;
    R my_v[L];
#pragma unroll
    for (int l = 0; l < L; ++l)
      my_v[l] = (in && l < lanes) ? Tr::to(vals[(size_t)my_i * lanes + l]) : R(0);
    int32_t out_k = kEmpty;
    R out_v[L];
#pragma unroll
    for (int l = 0; l < L; ++l) out_v[l] = R(0);

    unsigned live = __ballot_sync(kFull, my_k != kEmpty);
    while (live) {  // warp-uniform: every lane holds the same mask
      const int j = __ffs(live) - 1;
      live &= live - 1;
      const int32_t k = __shfl_sync(kFull, my_k, j);
      R v[L];
#pragma unroll
      for (int l = 0; l < L; ++l) v[l] = __shfl_sync(kFull, my_v[l], j);
      const R vl = pick(v, lane);  // this lane's value lane
      const size_t row = (size_t)fpe_hash(k, n_buckets) * ways;

      int hit_w = -1, empty_w = -1;
      for (int base = 0; base < ways; base += 32) {
        const int w = base + lane;
        const int32_t rk = (w < ways) ? tk[row + w] : kEmpty;
        const unsigned hm = __ballot_sync(kFull, w < ways && rk == k);
        const unsigned em = __ballot_sync(kFull, w < ways && rk == kEmpty);
        if (hit_w < 0 && hm) hit_w = base + __ffs(hm) - 1;
        if (empty_w < 0 && em) empty_w = base + __ffs(em) - 1;
      }

      if (hit_w >= 0) {  // hit: combine every lane in place
        if (lane < lanes) {
          T* p = tv + (row + hit_w) * lanes + lane;
          *p = Tr::from(combine<OP>(Tr::to(*p), vl));
        }
      } else if (empty_w >= 0) {  // miss + free way: insert
        if (lane == 0) tk[row + empty_w] = k;
        if (lane < lanes) tv[(row + empty_w) * lanes + lane] = Tr::from(vl);
      } else {  // miss + full: evict way 0, shift left, insert at last
        const int32_t k0 = tk[row];
        const R v0 = lane < lanes ? Tr::to(tv[row * lanes + lane]) : R(0);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const R t = __shfl_sync(kFull, v0, l);
          if (lane == j && l < lanes) out_v[l] = t;
        }
        if (lane == j) out_k = k0;
        __syncwarp();
        for (int base = 0; base < ways - 1; base += 32) {
          const int w = base + lane;
          const bool act = w < ways - 1;
          int32_t nk = kEmpty;
          T nv[L];
          if (act) {
            nk = tk[row + w + 1];
#pragma unroll
            for (int l = 0; l < L; ++l)
              if (l < lanes) nv[l] = tv[(row + w + 1) * lanes + l];
          }
          __syncwarp();
          if (act) {
            tk[row + w] = nk;
#pragma unroll
            for (int l = 0; l < L; ++l)
              if (l < lanes) tv[(row + w) * lanes + l] = nv[l];
          }
          __syncwarp();
        }
        if (lane == 0) tk[row + ways - 1] = k;
        if (lane < lanes) tv[(row + ways - 1) * lanes + lane] = Tr::from(vl);
      }
      __syncwarp();
    }
    if (in) {
      ev_k[my_i] = out_k;
#pragma unroll
      for (int l = 0; l < L; ++l)
        if (l < lanes) ev_v[(size_t)my_i * lanes + l] = Tr::from(out_v[l]);
    }
  }
}

template <int OP, typename T, int L>
__global__ void __launch_bounds__(kThreads)
fpe_kernel(const int32_t* __restrict__ keys, const T* __restrict__ vals,
           int n, int lanes, int n_buckets, int ways,
           const int32_t* __restrict__ init_k, const T* __restrict__ init_v,
           int32_t* out_tk, T* out_tv, int32_t* __restrict__ ev_k,
           T* __restrict__ ev_v, size_t key_bytes, int use_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t cap = (size_t)n_buckets * ways;
  int32_t* tk = out_tk;
  T* tv = out_tv;
  if (use_smem) {
    tk = reinterpret_cast<int32_t*>(smem);
    tv = reinterpret_cast<T*>(smem + key_bytes);
  }
  // start state: EMPTY_KEY and zeros, or the table passed in
  for (size_t j = threadIdx.x; j < cap; j += blockDim.x)
    tk[j] = init_k ? init_k[j] : kEmpty;
  for (size_t j = threadIdx.x; j < cap * lanes; j += blockDim.x)
    tv[j] = init_v ? init_v[j] : Traits<T>::from(0);
  __syncthreads();
  if (threadIdx.x < 32)
    scan_warp<OP, T, L>(keys, vals, n, lanes, (uint32_t)n_buckets, ways, tk,
                        tv, ev_k, ev_v);
  __syncthreads();
  if (use_smem) {  // end-of-task flush of the resident table
    for (size_t j = threadIdx.x; j < cap; j += blockDim.x) out_tk[j] = tk[j];
    for (size_t j = threadIdx.x; j < cap * lanes; j += blockDim.x)
      out_tv[j] = tv[j];
  }
}

size_t value_bytes(int dtype) { return dtype == kBF16 ? 2 : 4; }

size_t key_region(size_t cap) { return (cap * 4 + 15) / 16 * 16; }

size_t table_bytes(int n_buckets, int ways, int lanes, int dtype) {
  const size_t cap = (size_t)n_buckets * ways;
  return key_region(cap) + cap * lanes * value_bytes(dtype);
}

int shared_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return limit;
}

template <int OP, typename T>
int launch(const void* keys, const void* vals, int n, int lanes, int n_buckets,
           int ways, const void* init_k, const void* init_v, void* out_tk,
           void* out_tv, void* ev_k, void* ev_v, cudaStream_t stream) {
  const size_t bytes = table_bytes(n_buckets, ways, lanes,
                                   sizeof(T) == 2 ? kBF16 : kF32);
  const int use_smem = bytes <= (size_t)shared_limit();
  const size_t dyn = use_smem ? bytes : 0;
  // the compiled lane count: 1 and 2 exactly, 3-4 at run time
  auto kern = lanes == 1   ? &fpe_kernel<OP, T, 1>
              : lanes == 2 ? &fpe_kernel<OP, T, 2>
                           : &fpe_kernel<OP, T, kMaxLanes>;
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<1, kThreads, dyn, stream>>>(
      static_cast<const int32_t*>(keys), static_cast<const T*>(vals), n,
      lanes, n_buckets, ways, static_cast<const int32_t*>(init_k),
      static_cast<const T*>(init_v), static_cast<int32_t*>(out_tk),
      static_cast<T*>(out_tv), static_cast<int32_t*>(ev_k),
      static_cast<T*>(ev_v), key_region((size_t)n_buckets * ways), use_smem);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_op(int op, const void* keys, const void* vals, int n, int lanes,
              int n_buckets, int ways, const void* init_k, const void* init_v,
              void* out_tk, void* out_tv, void* ev_k, void* ev_v,
              cudaStream_t s) {
  switch (op) {
    case kSum:
      return launch<kSum, T>(keys, vals, n, lanes, n_buckets, ways, init_k,
                             init_v, out_tk, out_tv, ev_k, ev_v, s);
    case kMax:
      return launch<kMax, T>(keys, vals, n, lanes, n_buckets, ways, init_k,
                             init_v, out_tk, out_tv, ev_k, ev_v, s);
    case kMin:
      return launch<kMin, T>(keys, vals, n, lanes, n_buckets, ways, init_k,
                             init_v, out_tk, out_tv, ev_k, ev_v, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// 1 if a table of this geometry runs in shared memory, 0 if in global.
int fpe_table_in_shared(int n_buckets, int ways, int lanes, int dtype) {
  return table_bytes(n_buckets, ways, lanes, dtype) <= (size_t)shared_limit();
}

// Launch one FPE scan on `stream`.  keys [n] int32, vals [n, lanes];
// init_k/init_v the resume table ([cap], [cap, lanes]) or null; outputs
// the final table ([cap], [cap, lanes]) and the eviction stream ([n],
// [n, lanes]).  Returns cudaGetLastError() after the launch (0 = ok).
int fpe_aggregate_launch(const void* keys, const void* vals, int n, int lanes,
                         int n_buckets, int ways, int op, int dtype,
                         const void* init_k, const void* init_v, void* out_tk,
                         void* out_tv, void* ev_k, void* ev_v, void* stream) {
  if (n < 0 || lanes < 1 || lanes > kMaxLanes || n_buckets < 1 || ways < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (op == kLogSumExp)
        return launch<kLogSumExp, float>(keys, vals, n, lanes, n_buckets, ways,
                                         init_k, init_v, out_tk, out_tv, ev_k,
                                         ev_v, s);
      return launch_op<float>(op, keys, vals, n, lanes, n_buckets, ways,
                              init_k, init_v, out_tk, out_tv, ev_k, ev_v, s);
    case kBF16:
      if (op == kLogSumExp)
        return launch<kLogSumExp, __nv_bfloat16>(
            keys, vals, n, lanes, n_buckets, ways, init_k, init_v, out_tk,
            out_tv, ev_k, ev_v, s);
      return launch_op<__nv_bfloat16>(op, keys, vals, n, lanes, n_buckets,
                                      ways, init_k, init_v, out_tk, out_tv,
                                      ev_k, ev_v, s);
    case kI32:
      return launch_op<int32_t>(op, keys, vals, n, lanes, n_buckets, ways,
                                init_k, init_v, out_tk, out_tv, ev_k, ev_v, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
