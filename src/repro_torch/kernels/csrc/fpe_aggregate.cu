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
// EMPTY_KEY (-1) pads are skipped and leave (EMPTY_KEY, 0) in their slot,
// as does every pair that evicts nothing.  The table starts empty or from
// a table passed in (resume), and is written out once at the end (the
// end-of-task flush).
//
// Design: a bucket-parallel scan.  A pair reads and writes only its own
// bucket's row, and its eviction goes to its own index of the eviction
// stream, so walking each bucket's pairs in stream order gives the
// sequential scan's result bit for bit; buckets are independent.
//
//   partition  the wrapper orders the real pairs by bucket, stream order
//              kept within a bucket: `fpe_bucket_launch` hashes every key
//              (pads go to bucket n_buckets, past the last), then
//              torch.sort(stable=True) and torch.searchsorted on the card
//              give the permutation and each bucket's run.  torch's sort
//              is a radix sort over all SMs, the same tool the BPE uses;
//              a hand-written stable counting sort would need per-tile
//              bucket counters (tiles x buckets) and buys nothing here.
//              This launch gathers keys and values into run order, so
//              each walker reads its run contiguously.
//   walk       one worker per bucket.  ways <= 4: one thread per bucket,
//              32 buckets a warp; the row (ways keys, ways x lanes values)
//              lives in registers, every way index is a compile-time
//              constant, and the run is read in batches of 8 pairs, the
//              next batch loaded (and a later one prefetched into L2)
//              while this one is applied, so the chain waits on the row
//              update and not on loads.  ways > 4: one warp per bucket,
//              lane w holds way w (strided past 32), one __ballot_sync
//              gives the hit and empty masks; the row lives in the output
//              table in global memory, owned by that warp alone.
//   small      a stream of at most kSmallN pairs (a packet-sized resumed
//              ingest) is one launch with no partition: each block loads
//              the whole stream into shared memory with its buckets, and
//              each worker picks out its own bucket's pairs in order.
//   tables     S independent tables in one launch (every switch of a
//              simulated tier, `fpe_scan_tables`): table s owns the
//              stream slice [s*per, (s+1)*per) and the buckets
//              [s*n_buckets, (s+1)*n_buckets), so the S tables side by
//              side are one table of S*n_buckets buckets whose bucket id
//              is s*n_buckets + hash(k).  Only the bucket kernel adds the
//              offset; the walk reads starts[b] and the row at b*ways and
//              never rehashes, so it runs unchanged.  The one-launch path
//              hashes without the offset, so S > 1 always partitions.
//
// What bounds it on this card: the longest bucket chain.  A bucket's pairs
// are a dependent chain of row updates (a few tens of cycles each for a
// register row); the bytes, n*(8+8*lanes) in and out, move in
// microseconds at 3.35 TB/s.  Under Zipf keys the hottest bucket holds the
// hottest key: p1 = 6.5% of the pairs at skew 0.99 over 2^20 keys, about
// 544 K of the word count's 8.4 M, whatever the bucket count.
//
// Arithmetic mirrors repro_torch/core/aggops.py per op: bf16 combines in
// f32 and rounds to nearest even after every op; int32 sums wrap; max/min
// propagate NaN; logsumexp is jnp.logaddexp op by op (max(a,b) +
// log1p(exp(-|a-b|)), or a+b where a-b is NaN), each op rounded to the
// value dtype, exp and log1p computed in f64 and rounded to f32 as the
// plain version does.  count and mean are sums over their carried lanes.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfpe_aggregate.so fpe_aggregate.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int32_t kEmpty = -1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLanes = 4;
constexpr int kThreads = 128;
constexpr int kBatch = 8;  // pairs loaded ahead by a thread walker
constexpr int kThreadWays = 4;  // rows of up to 4 ways: a thread a bucket
constexpr int kSmallN = 4096;  // longest stream of the one-launch path

enum Op : int { kSum = 0, kMax = 1, kMin = 2, kLogSumExp = 3 };
enum DType : int { kF32 = 0, kBF16 = 1, kI32 = 2 };

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  using R = float;  // register type the combine runs in
  __device__ static R to(float v) { return v; }
  __device__ static float from(R v) { return v; }
  __device__ static float rnd(float v) { return v; }
};

template <>
struct Traits<__nv_bfloat16> {
  using R = float;
  __device__ static R to(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from(R v) { return __float2bfloat16_rn(v); }
  __device__ static float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <>
struct Traits<int32_t> {
  using R = int32_t;
  __device__ static R to(int32_t v) { return v; }
  __device__ static int32_t from(R v) { return v; }
};

// jnp.logaddexp's steps, each rounded to T; not inlined, so the f64 exp
// and log1p are compiled once per kernel rather than once per call site
template <typename T>
__device__ __noinline__ float logaddexp(float a, float b) {
  using Tr = Traits<T>;
  const float d = Tr::rnd(__fsub_rn(a, b));
  if (d != d) return Tr::rnd(__fadd_rn(a, b));
  const float m = a < b ? b : a;
  const float e = Tr::rnd(__double2float_rn(exp(-(double)fabsf(d))));
  const float l = Tr::rnd(__double2float_rn(log1p((double)e)));
  return Tr::rnd(__fadd_rn(m, l));
}

template <int OP, typename T>
__device__ __forceinline__ float combine(float a, float b) {
  using Tr = Traits<T>;
  if (OP == kSum) return Tr::rnd(__fadd_rn(a, b));
  if (OP == kMax)
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? b : a);
  if (OP == kMin)
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : (b < a ? b : a);
  return logaddexp<T>(a, b);
}

template <int OP, typename T>
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

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Everything a walker needs; pointers of the partition are null on the
// one-launch path.
template <typename T>
struct Args {
  const int32_t* keys;
  const T* vals;
  int n, lanes, n_buckets, ways;
  const int32_t* init_k;
  const T* init_v;
  int32_t* out_tk;
  T* out_tv;
  int32_t* ev_k;
  T* ev_v;
  const int64_t* starts;   // [n_buckets + 1] run offsets
  const int64_t* run_idx;  // [n] stream index of each run position
  const int32_t* run_k;    // [n] keys in run order
  const T* run_v;          // [n, lanes] values in run order
};

// The pads of the one-launch path: block 0 writes (EMPTY, 0) into their
// eviction slots (a real pair's slot is written by its bucket's worker).
template <typename T>
__device__ void small_pads(const Args<T>& a) {
  if (blockIdx.x != 0) return;
  for (int i = threadIdx.x; i < a.n; i += blockDim.x) {
    if (a.keys[i] != kEmpty) continue;
    a.ev_k[i] = kEmpty;
    for (int l = 0; l < a.lanes; ++l)
      a.ev_v[(size_t)i * a.lanes + l] = Traits<T>::from(0);
  }
}

// ---------------------------------------------------------------------------
// ways <= kThreadWays: one thread per bucket, the row in registers
// ---------------------------------------------------------------------------

template <int OP, typename T, int L, int W>
struct Row {
  using Tr = Traits<T>;
  using R = typename Tr::R;
  int32_t k[W];
  R v[W][L];

  __device__ void load(const Args<T>& a, size_t base, int lanes) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const bool on = w < a.ways;
      k[w] = (on && a.init_k) ? a.init_k[base + w] : kEmpty;
#pragma unroll
      for (int l = 0; l < L; ++l)
        v[w][l] = (on && a.init_v && l < lanes)
                      ? Tr::to(a.init_v[(base + w) * lanes + l])
                      : R(0);
    }
  }

  __device__ void store(const Args<T>& a, size_t base, int lanes) const {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (w >= a.ways) break;
      a.out_tk[base + w] = k[w];
#pragma unroll
      for (int l = 0; l < L; ++l)
        if (l < lanes) a.out_tv[(base + w) * lanes + l] = Tr::from(v[w][l]);
    }
  }

  // Apply one pair; true when it evicted (ok, ov).  A way past `ways`
  // holds EMPTY_KEY, which no real key equals.
  __device__ bool apply(int32_t key, const R (&x)[L], int ways, int32_t& ok,
                        R (&ov)[L]) {
    int hit = -1;
#pragma unroll
    for (int w = 0; w < W; ++w)
      if (hit < 0 && k[w] == key) hit = w;
    if (hit >= 0) {  // hit: combine every lane in place
      R cur[L];
#pragma unroll
      for (int l = 0; l < L; ++l) cur[l] = v[0][l];
#pragma unroll
      for (int w = 1; w < W; ++w)
        if (hit == w)
#pragma unroll
          for (int l = 0; l < L; ++l) cur[l] = v[w][l];
#pragma unroll
      for (int l = 0; l < L; ++l) cur[l] = combine<OP, T>(cur[l], x[l]);
#pragma unroll
      for (int w = 0; w < W; ++w)
        if (hit == w)
#pragma unroll
          for (int l = 0; l < L; ++l) v[w][l] = cur[l];
      return false;
    }
    int e = -1;
#pragma unroll
    for (int w = 0; w < W; ++w)
      if (e < 0 && w < ways && k[w] == kEmpty) e = w;
    if (e >= 0) {  // miss + free way: insert at the first
#pragma unroll
      for (int w = 0; w < W; ++w)
        if (e == w) {
          k[w] = key;
#pragma unroll
          for (int l = 0; l < L; ++l) v[w][l] = x[l];
        }
      return false;
    }
    // miss + full: evict way 0, shift left, insert at the last way
    ok = k[0];
#pragma unroll
    for (int l = 0; l < L; ++l) ov[l] = v[0][l];
#pragma unroll
    for (int w = 0; w + 1 < W; ++w)
      if (w + 1 < ways) {
        k[w] = k[w + 1];
#pragma unroll
        for (int l = 0; l < L; ++l) v[w][l] = v[w + 1][l];
      }
#pragma unroll
    for (int w = 0; w < W; ++w)
      if (w == ways - 1) {
        k[w] = key;
#pragma unroll
        for (int l = 0; l < L; ++l) v[w][l] = x[l];
      }
    return true;
  }
};

template <typename T, int L, typename R = typename Traits<T>::R>
__device__ __forceinline__ void load_batch(const Args<T>& a, int64_t i0,
                                           int64_t end, int lanes,
                                           int32_t (&kk)[kBatch],
                                           R (&vv)[kBatch][L]) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const bool in = i0 + j < end;
    kk[j] = in ? a.run_k[i0 + j] : kEmpty;
#pragma unroll
    for (int l = 0; l < L; ++l)
      vv[j][l] = (in && l < lanes)
                     ? Traits<T>::to(a.run_v[(i0 + j) * lanes + l])
                     : R(0);
  }
}

template <int OP, typename T, int L, int W>
__global__ void __launch_bounds__(kThreads)
fpe_thread_kernel(const Args<T> a) {
  using Tr = Traits<T>;
  using R = typename Tr::R;
  extern __shared__ int32_t smem[];  // one-launch path: keys [n], buckets [n]
  const bool small = a.starts == nullptr;
  const int lanes = L < kMaxLanes ? L : a.lanes;
  int32_t* sk = smem;
  int32_t* sb = smem + a.n;
  if (small) {
    for (int i = threadIdx.x; i < a.n; i += blockDim.x) {
      const int32_t k = a.keys[i];
      sk[i] = k;
      sb[i] = k == kEmpty ? -1 : (int32_t)fpe_hash(k, a.n_buckets);
    }
    small_pads(a);
    __syncthreads();
  }
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.n_buckets) return;
  const size_t base = (size_t)b * a.ways;
  Row<OP, T, L, W> row;
  row.load(a, base, lanes);
  int32_t ok;
  R ov[L];
  if (small) {
    for (int i = 0; i < a.n; ++i) {
      if (sb[i] != b) continue;
      R x[L];
#pragma unroll
      for (int l = 0; l < L; ++l)
        x[l] = l < lanes ? Tr::to(a.vals[(size_t)i * lanes + l]) : R(0);
      const bool ev = row.apply(sk[i], x, a.ways, ok, ov);
      a.ev_k[i] = ev ? ok : kEmpty;
#pragma unroll
      for (int l = 0; l < L; ++l)
        if (l < lanes)
          a.ev_v[(size_t)i * lanes + l] = Tr::from(ev ? ov[l] : R(0));
    }
  } else {
    const int64_t s = a.starts[b], e = a.starts[b + 1];
    int32_t ck[kBatch], nk[kBatch];
    R cv[kBatch][L], nv[kBatch][L];
    load_batch<T, L>(a, s, e, lanes, ck, cv);
    for (int64_t i = s; i < e; i += kBatch) {
      load_batch<T, L>(a, i + kBatch, e, lanes, nk, nv);
      const int64_t far = i + 16 * kBatch;
      if (far < e) {
        prefetch_l2(a.run_k + far);
        prefetch_l2(a.run_v + far * lanes);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i + j >= e) break;
        if (row.apply(ck[j], cv[j], a.ways, ok, ov)) {  // slots hold EMPTY/0
          const int64_t dst = a.run_idx[i + j];
          a.ev_k[dst] = ok;
#pragma unroll
          for (int l = 0; l < L; ++l)
            if (l < lanes) a.ev_v[dst * lanes + l] = Tr::from(ov[l]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        ck[j] = nk[j];
#pragma unroll
        for (int l = 0; l < L; ++l) cv[j][l] = nv[j][l];
      }
    }
  }
  row.store(a, base, lanes);
}

// ---------------------------------------------------------------------------
// ways > kThreadWays: one warp per bucket, lane w holds way w (strided
// past 32)
// ---------------------------------------------------------------------------

template <typename R, int L>
__device__ __forceinline__ R pick(const R (&v)[L], int l) {
  R out = v[0];
#pragma unroll
  for (int j = 1; j < L; ++j)
    if (l == j) out = v[j];
  return out;
}

template <int OP, typename T, int L>
__global__ void __launch_bounds__(kThreads)
fpe_warp_kernel(const Args<T> a) {
  using Tr = Traits<T>;
  using R = typename Tr::R;
  const bool small = a.starts == nullptr;
  if (small) small_pads(a);
  const int lanes = L < kMaxLanes ? L : a.lanes;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (b >= a.n_buckets) return;  // warp-uniform
  const int ways = a.ways;
  int32_t* tk = a.out_tk + (size_t)b * ways;
  T* tv = a.out_tv + (size_t)b * ways * lanes;
  for (int w = lane; w < ways; w += 32) {  // the row starts as init or empty
    tk[w] = a.init_k ? a.init_k[(size_t)b * ways + w] : kEmpty;
    for (int l = 0; l < lanes; ++l)
      tv[(size_t)w * lanes + l] =
          a.init_v ? a.init_v[((size_t)b * ways + w) * lanes + l]
                   : Tr::from(R(0));
  }
  __syncwarp();

  int64_t lo = 0, hi = a.n;
  if (!small) lo = a.starts[b], hi = a.starts[b + 1];
  for (int64_t i0 = lo; i0 < hi; i0 += 32) {
    // lane j loads pair i0 + j; on the one-launch path it is this warp's
    // only if its key hashes to bucket b
    const int64_t my_i = i0 + lane;
    const bool in = my_i < hi;
    const int32_t my_k = in ? (small ? a.keys[my_i] : a.run_k[my_i]) : kEmpty;
    const bool mine = small ? (my_k != kEmpty &&
                               fpe_hash(my_k, a.n_buckets) == (uint32_t)b)
                            : in;
    const T* src = small ? a.vals : a.run_v;
    R my_v[L];
#pragma unroll
    for (int l = 0; l < L; ++l)
      my_v[l] = (mine && l < lanes) ? Tr::to(src[my_i * lanes + l]) : R(0);
    int32_t out_k = kEmpty;
    R out_v[L];
#pragma unroll
    for (int l = 0; l < L; ++l) out_v[l] = R(0);

    unsigned live = __ballot_sync(kFull, mine);
    while (live) {  // warp-uniform: every lane holds the same mask
      const int j = __ffs(live) - 1;
      live &= live - 1;
      const int32_t k = __shfl_sync(kFull, my_k, j);
      R v[L];
#pragma unroll
      for (int l = 0; l < L; ++l) v[l] = __shfl_sync(kFull, my_v[l], j);
      const R vl = pick(v, lane);  // this lane's value lane

      int hit_w = -1, empty_w = -1;
      for (int base = 0; base < ways; base += 32) {
        const int w = base + lane;
        const int32_t rk = (w < ways) ? tk[w] : kEmpty;
        const unsigned hm = __ballot_sync(kFull, w < ways && rk == k);
        const unsigned em = __ballot_sync(kFull, w < ways && rk == kEmpty);
        if (hit_w < 0 && hm) hit_w = base + __ffs(hm) - 1;
        if (empty_w < 0 && em) empty_w = base + __ffs(em) - 1;
      }

      if (hit_w >= 0) {  // hit: combine every lane in place
        if (lane < lanes) {
          T* p = tv + (size_t)hit_w * lanes + lane;
          *p = Tr::from(combine<OP, T>(Tr::to(*p), vl));
        }
      } else if (empty_w >= 0) {  // miss + free way: insert
        if (lane == 0) tk[empty_w] = k;
        if (lane < lanes) tv[(size_t)empty_w * lanes + lane] = Tr::from(vl);
      } else {  // miss + full: evict way 0, shift left, insert at last
        const int32_t k0 = tk[0];
        const R v0 = lane < lanes ? Tr::to(tv[lane]) : R(0);
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
            nk = tk[w + 1];
#pragma unroll
            for (int l = 0; l < L; ++l)
              if (l < lanes) nv[l] = tv[(size_t)(w + 1) * lanes + l];
          }
          __syncwarp();
          if (act) {
            tk[w] = nk;
#pragma unroll
            for (int l = 0; l < L; ++l)
              if (l < lanes) tv[(size_t)w * lanes + l] = nv[l];
          }
          __syncwarp();
        }
        if (lane == 0) tk[ways - 1] = k;
        if (lane < lanes) tv[(size_t)(ways - 1) * lanes + lane] = Tr::from(vl);
      }
      __syncwarp();
    }
    // a real pair's eviction slot; the partitioned path's slots already
    // hold (EMPTY, 0), so only evictions are stored there
    if (mine && (small || out_k != kEmpty)) {
      const int64_t dst = small ? my_i : a.run_idx[my_i];
      a.ev_k[dst] = out_k;
#pragma unroll
      for (int l = 0; l < L; ++l)
        if (l < lanes) a.ev_v[dst * lanes + l] = Tr::from(out_v[l]);
    }
  }
}

// ---------------------------------------------------------------------------
// partition helpers
// ---------------------------------------------------------------------------

// bkt[i] = the bucket of keys[i] in table i / per (its buckets start at
// (i / per) * n_buckets), or pad_bucket for an EMPTY_KEY pad.
__global__ void fpe_bucket_kernel(const int32_t* __restrict__ keys, int n,
                                  int per, int n_buckets, int pad_bucket,
                                  int32_t* __restrict__ bkt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t k = keys[i];
  bkt[i] = k == kEmpty ? pad_bucket
                       : (i / per) * n_buckets +
                             (int32_t)fpe_hash(k, (uint32_t)n_buckets);
}

template <typename T>
__global__ void fpe_gather_kernel(const int32_t* __restrict__ keys,
                                  const T* __restrict__ vals, int n, int lanes,
                                  const int64_t* __restrict__ perm,
                                  int32_t* __restrict__ run_k,
                                  T* __restrict__ run_v) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t p = perm[i];
  run_k[i] = keys[p];
  for (int l = 0; l < lanes; ++l)
    run_v[(size_t)i * lanes + l] = vals[p * lanes + l];
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int OP, typename T, int L>
int launch_walk(const Args<T>& a, cudaStream_t stream) {
  const bool small = a.starts == nullptr;
  const size_t dyn = small ? (size_t)a.n * 2 * sizeof(int32_t) : 0;
  if (a.ways <= kThreadWays) {
    const int blocks = (a.n_buckets + kThreads - 1) / kThreads;
    fpe_thread_kernel<OP, T, L, kThreadWays>
        <<<blocks, kThreads, dyn, stream>>>(a);
  } else {
    const int per = kThreads / 32;
    const int blocks = (a.n_buckets + per - 1) / per;
    fpe_warp_kernel<OP, T, L><<<blocks, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int OP, typename T>
int launch_lanes(const Args<T>& a, cudaStream_t s) {
  // the compiled lane count: 1 exactly, 2-4 at run time
  return a.lanes == 1 ? launch_walk<OP, T, 1>(a, s)
                      : launch_walk<OP, T, kMaxLanes>(a, s);
}

template <typename T>
int launch(int op, const Args<T>& a, const int64_t* perm, cudaStream_t s) {
  if (a.starts) {  // partitioned: slots start as (EMPTY, 0), gather runs
    cudaError_t e = cudaMemsetAsync(a.ev_k, 0xff, (size_t)a.n * 4, s);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(a.ev_v, 0, (size_t)a.n * a.lanes * sizeof(T), s);
    if (e != cudaSuccess) return (int)e;
    if (a.n > 0)
      fpe_gather_kernel<T><<<(a.n + 255) / 256, 256, 0, s>>>(
          a.keys, a.vals, a.n, a.lanes, perm, const_cast<int32_t*>(a.run_k),
          const_cast<T*>(a.run_v));
  }
  switch (op) {
    case kSum: return launch_lanes<kSum, T>(a, s);
    case kMax: return launch_lanes<kMax, T>(a, s);
    case kMin: return launch_lanes<kMin, T>(a, s);
    case kLogSumExp:
      if constexpr (!std::is_same<T, int32_t>::value)
        return launch_lanes<kLogSumExp, T>(a, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int run(int op, const void* keys, const void* vals, int n, int lanes,
        int n_buckets, int ways, const void* init_k, const void* init_v,
        void* out_tk, void* out_tv, void* ev_k, void* ev_v, const void* perm,
        const void* starts, void* run_k, void* run_v, cudaStream_t s) {
  Args<T> a;
  a.keys = static_cast<const int32_t*>(keys);
  a.vals = static_cast<const T*>(vals);
  a.n = n;
  a.lanes = lanes;
  a.n_buckets = n_buckets;
  a.ways = ways;
  a.init_k = static_cast<const int32_t*>(init_k);
  a.init_v = static_cast<const T*>(init_v);
  a.out_tk = static_cast<int32_t*>(out_tk);
  a.out_tv = static_cast<T*>(out_tv);
  a.ev_k = static_cast<int32_t*>(ev_k);
  a.ev_v = static_cast<T*>(ev_v);
  a.starts = static_cast<const int64_t*>(starts);
  a.run_idx = static_cast<const int64_t*>(perm);
  a.run_k = static_cast<const int32_t*>(run_k);
  a.run_v = static_cast<const T*>(run_v);
  return launch<T>(op, a, a.run_idx, s);
}

}  // namespace

extern "C" {

// The buckets of S = n / per tables side by side: bkt[i] = (i / per) *
// n_buckets + the bucket of keys[i], or S * n_buckets (past the last
// bucket) for an EMPTY_KEY pad.  One table: per = n.
int fpe_bucket_launch(const void* keys, int n, int per, int n_buckets,
                      void* bkt, void* stream) {
  if (n < 0 || n_buckets < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (per < 1 || n % per != 0 ||
      (long long)(n / per) * n_buckets > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  fpe_bucket_kernel<<<(n + 255) / 256, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), n, per, n_buckets,
      (n / per) * n_buckets, static_cast<int32_t*>(bkt));
  return (int)cudaGetLastError();
}

// Launch one FPE scan on `stream`.  keys [n] int32, vals [n, lanes];
// init_k/init_v the resume table ([cap], [cap, lanes]) or null; outputs
// the final table ([cap], [cap, lanes]) and the eviction stream ([n],
// [n, lanes]).  The partition: perm [n] int64 (the stream indices ordered
// by bucket, stable), starts [n_buckets + 1] int64 (each bucket's run),
// run_k [n] and run_v [n, lanes] scratch; all four null for the one-launch
// path (n <= kSmallN).  Returns cudaGetLastError() after the launch
// (0 = ok).
int fpe_aggregate_launch(const void* keys, const void* vals, int n, int lanes,
                         int n_buckets, int ways, int op, int dtype,
                         const void* init_k, const void* init_v, void* out_tk,
                         void* out_tv, void* ev_k, void* ev_v, const void* perm,
                         const void* starts, void* run_k, void* run_v,
                         void* stream) {
  if (n < 0 || lanes < 1 || lanes > kMaxLanes || n_buckets < 1 || ways < 1)
    return (int)cudaErrorInvalidValue;
  const bool part = starts != nullptr;
  if (part != (perm != nullptr) || part != (run_k != nullptr) ||
      part != (run_v != nullptr) || (!part && n > kSmallN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return run<float>(op, keys, vals, n, lanes, n_buckets, ways, init_k,
                        init_v, out_tk, out_tv, ev_k, ev_v, perm, starts,
                        run_k, run_v, s);
    case kBF16:
      return run<__nv_bfloat16>(op, keys, vals, n, lanes, n_buckets, ways,
                                init_k, init_v, out_tk, out_tv, ev_k, ev_v,
                                perm, starts, run_k, run_v, s);
    case kI32:
      return run<int32_t>(op, keys, vals, n, lanes, n_buckets, ways, init_k,
                          init_v, out_tk, out_tv, ev_k, ev_v, perm, starts,
                          run_k, run_v, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
