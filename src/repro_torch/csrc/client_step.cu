// Fused client step for Hopper (sm_90a): cache gather + H local SGD steps.
//
// Replaces the Pallas TPU kernel repro/kernels/client_step/kernel.py:75
// (client_step_flat; body _client_body :41).
//
// For each client c of one size tier of the streaming shard cache:
//   w, b = broadcast server model
//   for h in 0..H-1:
//     rows  = xs[slot[c], idx[c, h*B : (h+1)*B], :]      (B gathered rows)
//     err_j = rows_j . w + b - ys[slot[c], idx[c, h*B + j]]
//     loss  = mean_j err_j^2
//     if mask[c, h] > 0:  w -= lr * (2/B) sum_j err_j rows_j ;
//                         b -= lr * (2/B) sum_j err_j
//   loss_out[c] = sum_h loss_h * mask[c, h] / max(sum_h mask[c, h], 1)
//
// What bounds it: per client it must read its H*B rows of D+1 floats once
// and write D+2 floats, about 4*H*B*D flops against 4*H*B*(D+1) bytes --
// 1 flop/byte, far below the card's ridge, so memory is the roofline term.
// At the streaming plane's shapes (C <= 8 clients, H = 4, B = 8, D = 64) a
// launch moves ~72 KB, 0.02 us at 3.35 TB/s: there the kernel sits at the
// launch floor plus its chain of dependent memory round trips, and the
// design is about making that chain short.  At wide shapes (hundreds of
// clients, D = 1024) bytes bound it and the design is about keeping copies
// in flight.  Unlike the TPU program, which copies each client's whole
// [N, D] slot into VMEM (kernel.py:94), both designs here touch only the
// rows a client uses.
//
// The staged design (the one every path runs):
//  * one block per client, sized to it: W = ceil(D / 128) warps, F =
//    ceil(D / (32 W)) <= 4 neighbouring features a thread (d = F t + f,
//    one vector load a row where D = 32 W F), whose weights stay in
//    registers for all H steps;
//  * two dependent round trips before the first step, not ~2 H B: first
//    the slot, the row ids of the staged steps (into shared memory), the
//    start weights, bias and masks, all independent loads; then every row
//    of every staged step and its y value in one burst of asynchronous
//    cp.async copies (16 bytes a thread where D % 4 == 0 and xs is
//    16-byte aligned, else 4 bytes; each thread reads four row ids before
//    it issues four copies), one commit group a step; a client of fewer
//    than four warps staged whole gets helper warps up to four, which
//    share the burst, wait for it with the client once and leave;
//  * a ring of K step buffers (K from the host's staging plan): K = H
//    when the whole client fits, else step h + K is issued as soon as step
//    h is consumed, and a step waits on its own commit group only;
//  * the B row dot products of a group of G rows (G = 8, 16 or 32 from
//    the host's plan: the least that holds B, or 8 where a wider group's
//    partials leave no room for one step) are
//    G per-lane partials, summed by one reduce-scatter across the warp
//    (five exchange rounds, each halving the values a lane holds), not G
//    serial butterflies; the residuals go back to every lane by
//    __shfl_sync, and each lane forms the gradient of its own features
//    from the rows' values it kept in registers (G F <= 32) or from the
//    staged rows;
//  * at D <= 128 one warp owns the client and nothing in a step waits on a
//    block barrier (__syncwarp only); at larger D the W warps meet once per
//    group of rows on a named barrier to sum their partials (double
//    buffered, so one barrier a group), and once a step to see its copies;
//  * a masked step leaves w and b as they were: the update is skipped, not
//    multiplied by zero.
// At the path's shape what is left after the two round trips is the H
// steps themselves, each a chain of one warp's dependent shared-memory
// reads, shuffles and adds (chip_smoke.py phase 4 times a step; PERF.md).
// The first design (v1, kept as a yardstick that no path runs): one block
// of 128 threads per client, each step gathering its rows with dependent
// row-id -> row loads, B serial butterflies and four block barriers a step.
//
// Both designs: the bias and the start weights come in as device pointers,
// so the caller never synchronises with the host to launch; a slot or row
// id out of range stops the kernel with a device-side assert (what
// PyTorch's own indexing does) instead of reading another client's rows;
// the host wrapper checks everything else before launch; offsets are
// 64-bit (S*N*D may pass 2^31).
//
// Rounding: the gradient is hand-fused and summed in another order than the
// plain PyTorch version (kernels/client_step/ref.py), so the two agree within
// fp32 tolerance, not bit for bit.  Built with --fmad=false: no contraction.
// The staged design's order is modelled operation for operation in
// tests/test_torch_client_step_model.py, which the card tests hold it to
// bit for bit.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFeatures = 1024;

// ---------------------------------------------------------------------------
// v1: the first design, a yardstick.
namespace v1 {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = kMaxFeatures / kThreads;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__host__ __device__ constexpr long long smem_bytes(int D, int B) {
  return 4LL * ((long long)B * D + (long long)kWarps * B + B);
}

__global__ void __launch_bounds__(kThreads)
client_step_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                   const int* __restrict__ slots, const int* __restrict__ idx,
                   const float* __restrict__ w0, const float* __restrict__ b0,
                   const float* __restrict__ mask,
                   float* __restrict__ w_out, float* __restrict__ b_out,
                   float* __restrict__ loss_out, int64_t S, int64_t N, int D,
                   int H, int B, float lr) {
  extern __shared__ float smem[];
  float* xb = smem;                   // [B][D] this step's gathered rows
  float* part = xb + (int64_t)B * D;  // [kWarps][B] per-warp dot products
  float* err = part + kWarps * B;     // [B] residuals

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slot = slots[c];
  assert(slot >= 0 && slot < S);
  const float* x_slot = xs + (int64_t)slot * N * D;
  const float* y_slot = ys + (int64_t)slot * N;
  const int* rows = idx + (int64_t)c * H * B;

  float w[kMaxPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int d = tid + k * kThreads;
    w[k] = d < D ? w0[d] : 0.0f;
  }
  float bias = *b0;
  const float two_over_b = 2.0f / (float)B;
  float lsum = 0.0f;
  float asum = 0.0f;

  for (int h = 0; h < H; ++h) {
    const int* step_rows = rows + h * B;
    for (int j = 0; j < B; ++j) {
      const int r = step_rows[j];
      assert(r >= 0 && r < N);
      const float* src = x_slot + (int64_t)r * D;
      for (int d = tid; d < D; d += kThreads) xb[j * D + d] = src[d];
    }
    __syncthreads();
    for (int j = 0; j < B; ++j) {
      float p = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxPerThread; ++k) {
        const int d = tid + k * kThreads;
        if (d < D) p += xb[j * D + d] * w[k];
      }
      p = warp_sum(p);
      if (lane == 0) part[warp * B + j] = p;
    }
    __syncthreads();
    for (int j = tid; j < B; j += kThreads) {
      float dot = 0.0f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) dot += part[q * B + j];
      err[j] = dot + bias - y_slot[step_rows[j]];
    }
    __syncthreads();
    float esum = 0.0f;
    float e2 = 0.0f;
    for (int j = 0; j < B; ++j) {
      esum += err[j];
      e2 += err[j] * err[j];
    }
    const float active = mask == nullptr ? 1.0f : mask[(int64_t)c * H + h];
    if (active > 0.0f) {
#pragma unroll
      for (int k = 0; k < kMaxPerThread; ++k) {
        const int d = tid + k * kThreads;
        if (d < D) {
          float g = 0.0f;
          for (int j = 0; j < B; ++j) g += err[j] * xb[j * D + d];
          w[k] -= lr * (two_over_b * g);
        }
      }
      bias -= lr * (two_over_b * esum);
    }
    lsum += (e2 / (float)B) * active;
    asum += active;
    __syncthreads();  // xb and err are rewritten by the next step
  }

#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int d = tid + k * kThreads;
    if (d < D) w_out[(int64_t)c * D + d] = w[k];
  }
  if (tid == 0) {
    b_out[c] = bias;
    loss_out[c] = lsum / fmaxf(asum, 1.0f);
  }
}

}  // namespace v1

// ---------------------------------------------------------------------------
// staged: every row of a client staged up front (a ring where it does not
// fit), warp-local reductions.
namespace staged {

// Block shape and shared memory; kernel.py staging_plan mirrors these.
__host__ __device__ inline int warps_for(int D) { return (D + 127) / 128; }
__host__ __device__ inline int features_for(int D) {
  const int t = 32 * warps_for(D);
  return (D + t - 1) / t;
}
// K step buffers of B rows, B y values and B row ids; with more than one
// warp, two buffers of per-warp partials of groups of G rows.
__host__ __device__ inline long long smem_bytes(int D, int B, int K, int G) {
  const int W = warps_for(D);
  const long long part = W > 1 ? 2LL * W * G : 0;
  return 4LL * ((long long)K * B * (D + 2) + part);
}
// Threads a block launches: the client's W warps, and where the whole
// client is staged at once (K == H) and they are fewer than four, helper
// warps up to four that share the burst of copies and then leave.
__host__ __device__ inline int block_threads(int D, int H, int K) {
  const int t = 32 * warps_for(D);
  return K == H && t < 128 ? 128 : t;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most ``n`` of this thread's commit groups are pending
// (n is an immediate; more than 7 pending waits as for 7: still correct).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n < 7 ? n : 7) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// The client's threads meet: one warp needs only __syncwarp; several meet
// on named barrier 1 (the block holds one client, so it counts them all).
__device__ __forceinline__ void client_sync(int nthreads) {
  if (nthreads == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync 1, %0;\n" :: "r"(nthreads) : "memory");
  }
}

// Reduce-scatter of G per-lane values across the warp: each of the five
// exchange rounds (OFF = 16, 8, .., 1) sends half of the N values a lane
// holds to its partner and adds the half it keeps; once one value is left
// the remaining rounds are plain butterflies.  Afterwards v[0] of lane l
// holds the warp's sum of value l / (32 / G).  Every round is its own
// instantiation, so every index into v is a constant and v stays in
// registers.
template <int N, int OFF, int G>
__device__ __forceinline__ void reduce_round(float (&v)[G], int lane) {
  if constexpr (N > 1) {
    constexpr int kHalf = N / 2;
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float send = upper ? v[i] : v[i + kHalf];
      const float keep = upper ? v[i + kHalf] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
  }
  if constexpr (OFF > 1) {
    reduce_round<(N > 1 ? N / 2 : 1), OFF / 2, G>(v, lane);
  }
}

template <int G>
__device__ __forceinline__ float reduce_scatter(float (&v)[G], int lane) {
  reduce_round<G, 16, G>(v, lane);
  return v[0];
}

// Issue the copies of rows [0, B) of width ``width`` copies of kBytes
// each: a thread walks its copies as (row, column) steps with no division
// in the loop, four at a time, reading their four row ids before issuing
// any of the four copies.
template <int kBytes>
__device__ __forceinline__ void issue_rows(float* xdst, const int* sid,
                                           const float* x_slot, int D,
                                           int B, int tid, int nthreads) {
  constexpr int kFloats = kBytes / 4;
  const int width = D / kFloats;  // copies a row
  const int n = B * width;
  int j = tid / width;
  int cc = tid - j * width;
  const int dj = nthreads / width;
  const int dcc = nthreads - dj * width;
  for (int q = tid; q < n; q += 4 * nthreads) {
    int jj[4], cs[4], rr[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      jj[u] = j;
      cs[u] = cc * kFloats;
      rr[u] = q + u * nthreads < n ? sid[j] : 0;
      j += dj;
      cc += dcc;
      if (cc >= width) {
        cc -= width;
        ++j;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (q + u * nthreads < n) {
        float* dst = xdst + jj[u] * D + cs[u];
        const float* src = x_slot + (int64_t)rr[u] * D + cs[u];
        if constexpr (kBytes == 16) {
          cp_async16(dst, src);
        } else {
          cp_async4(dst, src);
        }
      }
    }
  }
}

// Issue the copies of one step (its row ids already in ``sid``) into one
// ring buffer, then commit them as one group: rows 16 bytes a copy where
// D % 4 == 0 and xs is 16-byte aligned (vec), else 4 bytes; y values 4.
__device__ __forceinline__ void issue_step(
    float* xdst, float* ydst, const int* sid, const float* x_slot,
    const float* y_slot, int D, int B, bool vec, int tid, int nthreads) {
  if (vec) {
    issue_rows<16>(xdst, sid, x_slot, D, B, tid, nthreads);
  } else {
    issue_rows<4>(xdst, sid, x_slot, D, B, tid, nthreads);
  }
  for (int r = tid; r < B; r += nthreads) {
    cp_async4(ydst + r, y_slot + sid[r]);
  }
  cp_async_commit();
}

// Read one step's row ids into ``sid`` (checking each).
__device__ __forceinline__ void load_ids(int* sid, const int* step_rows,
                                         int B, int64_t N, int tid,
                                         int nthreads) {
  for (int j = tid; j < B; j += nthreads) {
    const int r = step_rows[j];
    assert(r >= 0 && r < N);
    sid[j] = r;
  }
}

// The F features of a lane (d = F tid + f) of a staged row, in one vector
// load where the row is whole (kExact: D = F T) and F is 2 or 4.  A
// feature past D (only where kExact is false) reads as 0; its weight is 0
// and stays 0.
template <int F, bool kExact>
__device__ __forceinline__ void lane_row(const float* row, int tid, int D,
                                         float (&x)[F]) {
  if constexpr (kExact && F == 4) {
    const float4 q = *reinterpret_cast<const float4*>(row + 4 * tid);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else if constexpr (kExact && F == 2) {
    const float2 q = *reinterpret_cast<const float2*>(row + 2 * tid);
    x[0] = q.x;
    x[1] = q.y;
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int d = F * tid + f;
      x[f] = (kExact || d < D) ? row[d] : 0.0f;
    }
  }
}

// One group of G rows (j0 .. j0+G-1) of a step: the G row dot products as
// per-lane partials, one reduce-scatter (and at T > 32 threads a meeting
// on the named barrier to sum the warps'), the residuals broadcast back,
// and their terms added to the lane's gradient, esum and e2.  The rows'
// features stay in registers between the two passes where G F <= 32.
// kTail: the group passes the step's B rows.
template <int F, int G, bool kExact, bool kTail>
__device__ __forceinline__ void run_group(
    const float* xb, const float* yb, int j0, int B, int D, int T, int tid,
    int lane, int warp, const float (&w)[F], float bias, float* pb,
    float (&g)[F], float& esum, float& e2) {
  constexpr bool kKeep = G * F <= 32;
  float xr[kKeep ? G : 1][F];
  float v[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    float x[F];
    if (!kTail || j0 + i < B) {
      lane_row<F, kExact>(xb + (j0 + i) * D, tid, D, x);
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) x[f] = 0.0f;
    }
    float p = 0.0f;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      p += x[f] * w[f];
      if constexpr (kKeep) xr[i][f] = x[f];
    }
    v[i] = p;
  }
  constexpr int kRowLanes = 32 / G;  // lanes holding one row's sum
  // the y value this lane needs, read before the shuffles wait on it
  const int jy = j0 + lane / kRowLanes;
  const float y = (T == 32 && (!kTail || jy < B)) ? yb[jy] : 0.0f;
  const float dot_w = reduce_scatter<G>(v, lane);
  float e = 0.0f;
  int src_stride;
  if (T == 32) {
    if (!kTail || jy < B) e = dot_w + bias - y;
    src_stride = kRowLanes;
  } else {
    if (lane % kRowLanes == 0) pb[warp * G + lane / kRowLanes] = dot_w;
    client_sync(T);
    if (lane < G && (!kTail || j0 + lane < B)) {
      float dot = 0.0f;
      for (int q = 0; q < (T >> 5); ++q) dot += pb[q * G + lane];
      e = dot + bias - yb[j0 + lane];
    }
    src_stride = 1;
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
    if (!kTail || j0 + i < B) {
      const float ei = __shfl_sync(0xffffffffu, e, i * src_stride);
      esum += ei;
      e2 += ei * ei;
      float x[F];
      if constexpr (kKeep) {
#pragma unroll
        for (int f = 0; f < F; ++f) x[f] = xr[i][f];
      } else {
        lane_row<F, kExact>(xb + (j0 + i) * D, tid, D, x);
      }
#pragma unroll
      for (int f = 0; f < F; ++f) g[f] += ei * x[f];
    }
  }
}

template <int F, int G, bool kExact>
__global__ void __launch_bounds__(256)
client_step_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                   const int* __restrict__ slots, const int* __restrict__ idx,
                   const float* __restrict__ w0, const float* __restrict__ b0,
                   const float* __restrict__ mask,
                   float* __restrict__ w_out, float* __restrict__ b_out,
                   float* __restrict__ loss_out, int64_t S, int64_t N, int D,
                   int H, int B, int K, float lr, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int T = 32 * warps_for(D);  // the client's threads
  const int W = T >> 5;
  const int NT = blockDim.x;        // with the helper warps, if any
  float* xring = smem;                                // [K][B][D]
  float* yring = xring + (int64_t)K * B * D;          // [K][B]
  int* sring = reinterpret_cast<int*>(yring + K * B); // [K][B] row ids
  float* part = reinterpret_cast<float*>(sring + K * B);  // [2][W][G]

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* rows = idx + (int64_t)c * H * B;

  // Round trip 1: every load that depends on nothing.
  const int slot = slots[c];
  float w[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int d = F * tid + f;  // helper threads (tid >= T) hold none
    w[f] = (tid < T && (kExact || d < D)) ? w0[d] : 0.0f;
  }
  float bias = *b0;
  // step h's mask for h < 32 rides in lane h; later steps read it directly
  const float* cmask = mask == nullptr ? nullptr : mask + (int64_t)c * H;
  const float mreg = cmask != nullptr && lane < H ? cmask[lane] : 1.0f;
  // the ids of steps 0..K-1 lie in the ring's id buffers in idx's order
  load_ids(sring, rows, K * B, N, tid, NT);
  assert(slot >= 0 && slot < S);
  const float* x_slot = xs + (int64_t)slot * N * D;
  const float* y_slot = ys + (int64_t)slot * N;
  const bool vec16 = vec != 0;
  if (NT > T) {
    __syncthreads();
  } else {
    client_sync(T);
  }

  // Round trip 2: every row of the K staged steps in one burst.
  for (int s = 0; s < K; ++s) {
    issue_step(xring + (int64_t)s * B * D, yring + s * B, sring + s * B,
               x_slot, y_slot, D, B, vec16, tid, NT);
  }
  if (NT > T) {
    // the helpers' copies land before the first step, then they leave
    cp_async_wait(0);
    __syncthreads();
    if (tid >= T) return;
  }

  const float two_over_b = 2.0f / (float)B;
  // e2 / B is e2 * (1 / B) exactly where B is a power of two
  const bool b_pow2 = (B & (B - 1)) == 0;
  const float inv_b = 1.0f / (float)B;
  const int full = B / G;       // groups of G rows with no ragged tail
  float lsum = 0.0f;
  float asum = 0.0f;
  int group = 0;                // running group count: part's buffer
  for (int h = 0, k = 0; h < H; ++h, k = k + 1 == K ? 0 : k + 1) {
    const float* xb = xring + (int64_t)k * B * D;  // ring buffer k = h % K
    const float* yb = yring + k * B;
    if (NT == T) {
      cp_async_wait(min(K - 1, H - 1 - h));
      client_sync(T);
    }

    float g[F];
#pragma unroll
    for (int f = 0; f < F; ++f) g[f] = 0.0f;
    float esum = 0.0f;
    float e2 = 0.0f;
    for (int q = 0; q < full; ++q, ++group) {
      run_group<F, G, kExact, false>(xb, yb, q * G, B, D, T, tid, lane, warp,
                                     w, bias, part + (group & 1) * W * G, g,
                                     esum, e2);
    }
    if (full * G < B) {
      run_group<F, G, kExact, true>(xb, yb, full * G, B, D, T, tid, lane,
                                    warp, w, bias,
                                    part + (group & 1) * W * G, g, esum, e2);
      ++group;
    }
    float active = 1.0f;
    if (cmask != nullptr) {
      active = h < 32 ? __shfl_sync(0xffffffffu, mreg, h) : cmask[h];
    }
    if (active > 0.0f) {
#pragma unroll
      for (int f = 0; f < F; ++f) w[f] -= lr * (two_over_b * g[f]);
      bias -= lr * (two_over_b * esum);
    }
    lsum += (b_pow2 ? e2 * inv_b : e2 / (float)B) * active;
    asum += active;

    // refill this buffer with step h + K once every thread is done with it
    if (h + K < H) {
      load_ids(sring + k * B, rows + (int64_t)(h + K) * B, B, N, tid, T);
      client_sync(T);  // every thread is done with buffer k; ids visible
      issue_step(xring + (int64_t)k * B * D, yring + k * B, sring + k * B,
                 x_slot, y_slot, D, B, vec16, tid, T);
    }
  }

#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int d = F * tid + f;
    if (kExact || d < D) w_out[(int64_t)c * D + d] = w[f];
  }
  if (tid == 0) {
    b_out[c] = bias;
    loss_out[c] = lsum / fmaxf(asum, 1.0f);
  }
}

using KernelFn = void (*)(const float*, const float*, const int*, const int*,
                          const float*, const float*, const float*, float*,
                          float*, float*, int64_t, int64_t, int, int, int,
                          int, float, int);

template <int F, int G>
KernelFn pick_exact(bool exact) {
  return exact ? client_step_kernel<F, G, true>
               : client_step_kernel<F, G, false>;
}

template <int F>
KernelFn pick_group(int G, bool exact) {
  switch (G) {
    case 8: return pick_exact<F, 8>(exact);
    case 16: return pick_exact<F, 16>(exact);
    default: return pick_exact<F, 32>(exact);
  }
}

// The instantiation for (F, G, exact), and its index among them.
KernelFn pick(int F, int G, bool exact, int* which) {
  *which = ((F - 1) * 3 + (G == 8 ? 0 : (G == 16 ? 1 : 2))) * 2 + exact;
  switch (F) {
    case 1: return pick_group<1>(G, exact);
    case 2: return pick_group<2>(G, exact);
    case 3: return pick_group<3>(G, exact);
    default: return pick_group<4>(G, exact);
  }
}

}  // namespace staged

// Raise a kernel's dynamic shared-memory cap to ``bytes`` where it passes
// the 48 KB default; the cap only grows, so a CUDA graph captured after the
// first launch at a shape never calls this.
constexpr int kMaxDevices = 16;
constexpr int kKernels = 25;  // v1 and the 24 staged instantiations

cudaError_t allow_smem(const void* fn, int which, long long bytes) {
  static int granted[kMaxDevices][kKernels] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int* cap = dev < kMaxDevices ? &granted[dev][which] : nullptr;
  if (cap != nullptr && *cap >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && cap != nullptr) *cap = (int)bytes;
  return e;
}

}  // namespace

// The design codes of client_step_launch: the staged design with helper
// warps where it wants them (the path's), and without (a yardstick).
enum { kDesignV1 = 0, kDesignStaged = 1, kDesignStagedSolo = 2 };

// Shared memory one block of ``design`` needs, in bytes (``ring`` step
// buffers and groups of ``group`` rows for the staged designs; both
// ignored by v1).
extern "C" long long client_step_smem_bytes(int D, int B, int ring,
                                            int group, int design) {
  return design == kDesignV1 ? v1::smem_bytes(D, B)
                             : staged::smem_bytes(D, B, ring, group);
}

// The most dynamic shared memory a block may opt in to on ``device``
// (negative on error).
extern "C" int client_step_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return v;
}

// The most features one block takes (both designs).
extern "C" int client_step_max_features() { return kMaxFeatures; }

// One launch over C clients.  ``ring`` and ``group`` are the staged
// design's number of step buffers (1..H) and rows a group (8, 16 or 32),
// both from kernel.py staging_plan; ``design`` a code above.
extern "C" int client_step_launch(const float* xs, const float* ys,
                                  const int* slots, const int* idx,
                                  const float* w, const float* b,
                                  const float* mask, float* w_out,
                                  float* b_out, float* loss_out, long long S,
                                  long long N, int D, int C, int H, int B,
                                  float lr, int ring, int group,
                                  int design, void* stream) {
  if (S < 1 || N < 1 || D < 1 || D > kMaxFeatures || C < 0 || H < 1 ||
      B < 1 || design < kDesignV1 || design > kDesignStagedSolo ||
      (design != kDesignV1 && (ring < 1 || ring > H ||
                               (group != 8 && group != 16 && group != 32)))) {
    return (int)cudaErrorInvalidValue;
  }
  if (C == 0) return (int)cudaGetLastError();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long smem = client_step_smem_bytes(D, B, ring, group, design);
  if (design == kDesignV1) {
    const cudaError_t e = allow_smem((const void*)v1::client_step_kernel, 0,
                                     smem);
    if (e != cudaSuccess) return (int)e;
    v1::client_step_kernel<<<C, v1::kThreads, (size_t)smem, st>>>(
        xs, ys, slots, idx, w, b, mask, w_out, b_out, loss_out, S, N, D, H, B,
        lr);
    return (int)cudaGetLastError();
  }
  const int F = staged::features_for(D);
  const int T = 32 * staged::warps_for(D);
  int which = 0;
  const staged::KernelFn fn =
      staged::pick(F, group, D % T == 0, &which);
  const cudaError_t e = allow_smem((const void*)fn, 1 + which, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = (D % 4 == 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0);
  const int threads =
      design == kDesignStagedSolo ? T : staged::block_threads(D, H, ring);
  fn<<<C, threads, (size_t)smem, st>>>(
      xs, ys, slots, idx, w, b, mask, w_out, b_out, loss_out, S, N, D, H, B,
      ring, lr, vec);
  return (int)cudaGetLastError();
}
