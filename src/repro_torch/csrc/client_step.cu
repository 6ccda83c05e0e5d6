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
// and write D+2 floats, about 2*H*B*D flops against 4*H*B*(D+1) bytes --
// 0.5 flop/byte, far below the card's ridge, so memory is the roofline
// term.  At the streaming plane's shapes (C_i <= 8 clients, H = 4, B = 8,
// D = 64) a launch moves ~72 KB, 0.02 us at 3.35 TB/s: the kernel sits at
// launch latency plus H dependent gather -> reduce -> update steps, each
// ending in block-wide barriers.  The design keeps the work in one launch per
// tier and touches only the rows the client uses: the TPU program copies the
// client's whole [N, D] slot into VMEM (kernel.py:94), which for an
// 8192-row slot would be 2 MB of reads for 8 KB of used rows.
//
// Design, against the TPU kernel's one-program-per-client grid:
//  * one block of 128 threads per client (grid = C); the block reads its own
//    slot id and row ids (no scalar prefetch);
//  * thread t owns the features d = t, t + 128, ... (D <= 1024): their
//    weights stay in registers for all H steps, as the TPU body carries w;
//  * each step gathers its B rows into shared memory (neighbouring threads
//    read neighbouring d, 64-bit offsets: S*N*D may pass 2^31), reduces the
//    B row dot products with warp shuffles and one cross-warp pass, then each
//    thread forms the gradient of its own features from shared memory;
//  * the bias and the start weights come in as device pointers, so the
//    caller never synchronises with the host to launch;
//  * a slot or row id out of range stops the kernel with a device-side
//    assert (what PyTorch's own indexing does) instead of reading another
//    client's rows; the host wrapper checks everything else before launch.
//
// Rounding: the gradient is hand-fused and summed in another order than the
// plain PyTorch version (kernels/client_step/ref.py), so the two agree within
// fp32 tolerance, not bit for bit.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 8;  // features per thread: D <= 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
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

}  // namespace

// Shared memory one block needs, in bytes.
extern "C" long long client_step_smem_bytes(int D, int B) {
  return 4LL * ((long long)B * D + (long long)kWarps * B + B);
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

// The most features one block takes (threads x registers per thread).
extern "C" int client_step_max_features() { return kThreads * kMaxPerThread; }

extern "C" int client_step_launch(const float* xs, const float* ys,
                                  const int* slots, const int* idx,
                                  const float* w, const float* b,
                                  const float* mask, float* w_out,
                                  float* b_out, float* loss_out, long long S,
                                  long long N, int D, int C, int H, int B,
                                  float lr, void* stream) {
  if (S < 1 || N < 1 || D < 1 || D > kThreads * kMaxPerThread || C < 0 ||
      H < 1 || B < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (C == 0) return (int)cudaGetLastError();
  const long long smem = client_step_smem_bytes(D, B);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        client_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  client_step_kernel<<<C, kThreads, (size_t)smem,
                       static_cast<cudaStream_t>(stream)>>>(
      xs, ys, slots, idx, w, b, mask, w_out, b_out, loss_out, S, N, D, H, B,
      lr);
  return (int)cudaGetLastError();
}
