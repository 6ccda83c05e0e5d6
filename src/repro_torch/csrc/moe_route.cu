// MoE token routing by index for Hopper (sm_90a): tokens into their
// experts' capacity slots, the experts' outputs back into tokens, and the
// gate gradient.
//
// Replaces no TPU kernel.  It replaces the JAX package's dense einsum
// dispatch (repro/models/layers.py moe_apply): one-hot dispatch and combine
// tensors [G, E, C] and the products gec,gd->ecd and gec,ecd->gd, which
// suit a TPU's matrix unit.  On this card, in fp32 with TF32 off, those
// products run on the CUDA cores and multiply by 0 and 1: at
// granite-moe-1b-a400m's training group (G = 2048 tokens, E = 32 experts,
// top k = 8, capacity C = 640, D = 1024) each is 2 G E C D = 85.9 GFLOP, and
// a layer's forward, remat recompute and backward do 601 GFLOP of them
// against 258 GFLOP for its experts.  By index each kept route's row moves
// once.
//
// Tables (built by the caller from the routes, kernels/moe_route/ops.py):
//   slot  [N, G, k] int32: e * C + pos of route (g, j), -1 where dropped;
//   owner [N, S] int32 (S = E * C): the route g * k + j that holds slot s,
//         -1 where the slot is empty.
// N independent groups of G tokens; T is float or bf16; w may be null (1).
//   gather_rows: out[n, s, :] = w[n, owner] * src[n, owner / k, :], or 0
//                for an empty slot.  The dispatch (w null: a copy, bit-equal
//                to the one-hot product) and the combine's backward (w the
//                gate: dy into the slots).
//   sum_rows:    out[n, g, :] = sum_j w[n, g, j] * src[n, slot[n, g, j], :]
//                over the kept routes in ascending slot order, accumulated
//                in fp32 and rounded once.  The combine (w the gate) and
//                the dispatch's backward (w null: dx).
//   route_dots:  dots[n, g, j] = <a[n, g, :], b[n, slot[n, g, j], :]>, 0
//                for a dropped route: the gate gradient <dy[g], ye[slot]>.
//                Each lane sums its vectors in order, then the warp adds
//                its 32 partial sums by a butterfly of shuffles.
//
// What bounds them: bytes.  At the training group above gather_rows writes
// 83.9 MB of slots and reads at most 8.4 MB of tokens (~27 us at
// 3.35 TB/s); sum_rows reads at most G k = 16,384 slot rows (67 MB) and
// writes 8.4 MB (~23 us); route_dots reads the same slot rows and the
// tokens (~23 us).  The flops (one multiply-add a byte or less) are
// nothing.  chip_smoke.py prints each kernel beside its bound.
//
// Design: one warp a row (a slot, a token or a route), 16-byte vector
// loads and stores where D allows (D a multiple of 4 fp32 or 8 bf16; else
// one element a lane), no shared state between warps, no atomics, no
// synchronisation beyond the warp.  A lane takes its row in chunks of
// kChunk = 32 elements (8 vectors of fp32, 4 of bf16), all of a chunk's
// loads issued before their first use.  sum_rows ranks its token's k <= 32
// routes by slot with shuffles, keeps the order in 256 bytes of shared
// memory a warp, and adds the routes inside a chunk with the chunk's
// accumulators in registers, so any D fits in registers.
//
// Rounding: every product is __fmul_rn and every sum __fadd_rn (the build
// also passes --fmad=false): the plain version (kernels/moe_route/ref.py)
// performs the same operations in the same order, so the two agree bit for
// bit.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;             // elements a lane a column chunk
constexpr int kMaxK = 32;              // routes a token: one lane each
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
  return __float2bfloat16_rn(x);
}

// V consecutive elements: one 16-byte access when V * sizeof(T) == 16.
template <typename T, int V> struct Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  Vec<T, V> x;
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(&x) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) x.v[e] = p[e];
  }
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = to_f(x.v[e]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  Vec<T, V> x;
#pragma unroll
  for (int e = 0; e < V; ++e) x.v[e] = from_f<T>(in[e]);
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&x);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = x.v[e];
  }
}

template <typename T, int V>
__device__ __forceinline__ void zero(T* dst) {
  float z[V];
#pragma unroll
  for (int e = 0; e < V; ++e) z[e] = 0.f;
  store<T, V>(dst, z);
}

// One warp a slot row of out [N, S, D].  A lane moves kChunk / V vectors
// at once: every load of a chunk is issued before its first store.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ src, const int* __restrict__ owner,
                   const T* __restrict__ w, T* __restrict__ out, int64_t rows,
                   int64_t S, int64_t G, int k, int D) {
  constexpr int U = kChunk / V;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = D / V;
  T* dst = out + row * D;
  const int o = owner[row];
  if (o < 0) {
    for (int c = lane; c < nvec; c += 32) zero<T, V>(dst + c * V);
    return;
  }
  const int64_t n = row / S;
  const T* s = src + (n * G + o / k) * D;
  const float scale = w == nullptr ? 1.f : to_f(w[n * G * k + o]);
  for (int c0 = lane; c0 < nvec; c0 += 32 * U) {
    float x[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + 32 * u < nvec) load<T, V>(s + (c0 + 32 * u) * V, x[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + 32 * u < nvec) {
        if (w != nullptr) {
#pragma unroll
          for (int e = 0; e < V; ++e) x[u][e] = __fmul_rn(x[u][e], scale);
        }
        store<T, V>(dst + (c0 + 32 * u) * V, x[u]);
      }
    }
  }
}

// One warp a token row of out [N, G, D].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
sum_rows_kernel(const T* __restrict__ src, const int* __restrict__ slot,
                const T* __restrict__ w, T* __restrict__ out, int64_t rows,
                int64_t S, int64_t G, int k, int D) {
  __shared__ int order_slot[kWarps][kMaxK];
  __shared__ float order_w[kWarps][kMaxK];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= rows) return;
  const int64_t n = row / G;
  // lane j < k holds route j; a kept route's rank is the number of kept
  // routes of the token with a lower slot (kept slots are distinct)
  const int my = lane < k ? slot[row * k + lane] : -1;
  const float my_w = (lane < k && w != nullptr) ? to_f(w[row * k + lane])
                                                : 1.f;
  int rank = 0;
  for (int i = 0; i < k; ++i) {
    const int other = __shfl_sync(kFull, my, i);
    rank += (other >= 0 && other < my) ? 1 : 0;
  }
  const unsigned kept = __ballot_sync(kFull, my >= 0);
  if (my >= 0) {
    order_slot[warp][rank] = my;
    order_w[warp][rank] = my_w;
  }
  __syncwarp();
  const int n_kept = __popc(kept);
  const int nvec = D / V;
  const T* base = src + n * S * D;
  T* dst = out + row * D;
  constexpr int U = kChunk / V;
  for (int c0 = lane; c0 < nvec; c0 += 32 * U) {
    float acc[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[u][e] = 0.f;
    for (int t = 0; t < n_kept; ++t) {
      const T* s = base + (int64_t)order_slot[warp][t] * D;
      const float wt = order_w[warp][t];
      float x[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (c0 + 32 * u < nvec) load<T, V>(s + (c0 + 32 * u) * V, x[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[u][e] = __fadd_rn(acc[u][e], w == nullptr
                                               ? x[u][e]
                                               : __fmul_rn(x[u][e], wt));
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + 32 * u < nvec) store<T, V>(dst + (c0 + 32 * u) * V, acc[u]);
  }
}

// One warp a route (n, g, j) of dots [N, G, k].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
route_dots_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const int* __restrict__ slot, T* __restrict__ dots,
                  int64_t routes, int64_t S, int64_t G, int k, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= routes) return;
  const int s = slot[r];
  if (s < 0) {
    if (lane == 0) dots[r] = from_f<T>(0.f);
    return;
  }
  const int64_t tok = r / k;             // n * G + g
  const int64_t n = tok / G;
  const T* pa = a + tok * D;
  const T* pb = b + (n * S + s) * D;
  const int nvec = D / V;
  constexpr int U = kChunk / V;
  float acc = 0.f;
  for (int c0 = lane; c0 < nvec; c0 += 32 * U) {
    float x[U][V], y[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + 32 * u < nvec) {
        load<T, V>(pa + (c0 + 32 * u) * V, x[u]);
        load<T, V>(pb + (c0 + 32 * u) * V, y[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + 32 * u < nvec) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc = __fadd_rn(acc, __fmul_rn(x[u][e], y[u][e]));
      }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  if (lane == 0) dots[r] = from_f<T>(acc);
}

inline unsigned blocks(int64_t rows) {
  return (unsigned)((rows + kWarps - 1) / kWarps);
}

}  // namespace

// Entry points.  dtype: 0 float32, 1 bfloat16; vec: 16-byte vectors (D a
// multiple of 16 / sizeof(T), every pointer 16-byte aligned) or one element
// a lane.  A null w means a weight of 1.
extern "C" {

int moe_route_max_k() { return kMaxK; }

int moe_gather_rows(const void* src, const int* owner, const void* w,
                    void* out, long long N, long long G, int k, long long S,
                    int D, int dtype, int vec, void* stream) {
  const int64_t rows = (int64_t)N * S;
  if (rows == 0 || D == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec)
      gather_rows_kernel<float, 4><<<blocks(rows), kThreads, 0, s>>>(
          (const float*)src, owner, (const float*)w, (float*)out, rows, S, G,
          k, D);
    else
      gather_rows_kernel<float, 1><<<blocks(rows), kThreads, 0, s>>>(
          (const float*)src, owner, (const float*)w, (float*)out, rows, S, G,
          k, D);
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    if (vec)
      gather_rows_kernel<B, 8><<<blocks(rows), kThreads, 0, s>>>(
          (const B*)src, owner, (const B*)w, (B*)out, rows, S, G, k, D);
    else
      gather_rows_kernel<B, 1><<<blocks(rows), kThreads, 0, s>>>(
          (const B*)src, owner, (const B*)w, (B*)out, rows, S, G, k, D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int moe_sum_rows(const void* src, const int* slot, const void* w, void* out,
                 long long N, long long G, int k, long long S, int D,
                 int dtype, int vec, void* stream) {
  const int64_t rows = (int64_t)N * G;
  if (rows == 0 || D == 0) return 0;
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec)
      sum_rows_kernel<float, 4><<<blocks(rows), kThreads, 0, s>>>(
          (const float*)src, slot, (const float*)w, (float*)out, rows, S, G,
          k, D);
    else
      sum_rows_kernel<float, 1><<<blocks(rows), kThreads, 0, s>>>(
          (const float*)src, slot, (const float*)w, (float*)out, rows, S, G,
          k, D);
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    if (vec)
      sum_rows_kernel<B, 8><<<blocks(rows), kThreads, 0, s>>>(
          (const B*)src, slot, (const B*)w, (B*)out, rows, S, G, k, D);
    else
      sum_rows_kernel<B, 1><<<blocks(rows), kThreads, 0, s>>>(
          (const B*)src, slot, (const B*)w, (B*)out, rows, S, G, k, D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int moe_route_dots(const void* a, const void* b, const int* slot, void* dots,
                   long long N, long long G, int k, long long S, int D,
                   int dtype, int vec, void* stream) {
  const int64_t routes = (int64_t)N * G * k;
  if (routes == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec)
      route_dots_kernel<float, 4><<<blocks(routes), kThreads, 0, s>>>(
          (const float*)a, (const float*)b, slot, (float*)dots, routes, S, G,
          k, D);
    else
      route_dots_kernel<float, 1><<<blocks(routes), kThreads, 0, s>>>(
          (const float*)a, (const float*)b, slot, (float*)dots, routes, S, G,
          k, D);
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    if (vec)
      route_dots_kernel<B, 8><<<blocks(routes), kThreads, 0, s>>>(
          (const B*)a, (const B*)b, slot, (B*)dots, routes, S, G, k, D);
    else
      route_dots_kernel<B, 1><<<blocks(routes), kThreads, 0, s>>>(
          (const B*)a, (const B*)b, slot, (B*)dots, routes, S, G, k, D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
