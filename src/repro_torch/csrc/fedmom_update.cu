// Fused server update for Hopper (sm_90a): FedMom and FedAvgM in one pass.
//
// Replaces the Pallas TPU kernel repro/kernels/fedmom_update/kernel.py:61
// (fused_flat; bodies _fedmom_body :39 and _fedavgm_body :49).
//
//   FedMom  (kind 0):  v' = w - eta*d ;  w' = v' + beta*(v' - v)
//   FedAvgM (kind 1):  m' = beta*m + d ; w' = w - eta*m'
//
// What bounds it: 3 float32 reads (w, state, delta) and 2 writes (w', state')
// per element, 20 bytes, and 4-5 flops -- far below the card's 295 flop/byte
// ridge, so device memory is the only roofline term: 20*n bytes at 3.35 TB/s.
// At LeNet size (n = 40,914) that is 0.82 MB and 0.24 us, well under the few
// microseconds a launch costs, so on the main path the update is
// launch-latency-bound; the design therefore keeps it to ONE launch per server
// step (the wrapper packs every leaf into one flat stream) and leaves the
// bandwidth-bound regime (multi-billion-parameter states) to the vector path.
//
// Design, against the TPU kernel's [256, 128] VMEM tiles:
//  * one grid-stride loop over a flat stream of any length n: no padding to
//    a tile grid, no tile-count constraint, a ragged tail masked per element;
//  * 16-byte (float4) loads and stores when all five pointers are 16-byte
//    aligned (neighbouring threads on neighbouring addresses), scalar loads
//    for the tail of at most 3 elements and for unaligned streams;
//  * the update kind is a template parameter, so each body is branch-free.
//
// Rounding: every operation is an explicit round-to-nearest intrinsic
// (__fmul_rn / __fadd_rn / __fsub_rn), which the compiler never contracts
// into an FMA (the build also passes --fmad=false).  The plain PyTorch
// version (kernels/fedmom_update/ref.py) performs the same operations in the
// same order, so the two agree bit for bit.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFedMom = 0;
constexpr int kFedAvgM = 1;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 resident blocks per H100 SM

template <int KIND>
__device__ __forceinline__ void update(float w, float s, float d, float eta,
                                       float beta, float& w_out,
                                       float& s_out) {
  if (KIND == kFedMom) {
    const float v_new = __fsub_rn(w, __fmul_rn(eta, d));
    w_out = __fadd_rn(v_new, __fmul_rn(beta, __fsub_rn(v_new, s)));
    s_out = v_new;
  } else {
    const float m_new = __fadd_rn(__fmul_rn(beta, s), d);
    w_out = __fsub_rn(w, __fmul_rn(eta, m_new));
    s_out = m_new;
  }
}

template <int KIND, bool VEC>
__global__ void __launch_bounds__(kThreads)
fedmom_update_kernel(const float* __restrict__ w, const float* __restrict__ s,
                     const float* __restrict__ d, float* __restrict__ w_out,
                     float* __restrict__ s_out, int64_t n, float eta,
                     float beta) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t start = 0;
  if (VEC) {
    const int64_t n4 = n / 4;
    const float4* w4 = reinterpret_cast<const float4*>(w);
    const float4* s4 = reinterpret_cast<const float4*>(s);
    const float4* d4 = reinterpret_cast<const float4*>(d);
    float4* wo4 = reinterpret_cast<float4*>(w_out);
    float4* so4 = reinterpret_cast<float4*>(s_out);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 a = w4[i];
      const float4 b = s4[i];
      const float4 c = d4[i];
      float4 x, y;
      update<KIND>(a.x, b.x, c.x, eta, beta, x.x, y.x);
      update<KIND>(a.y, b.y, c.y, eta, beta, x.y, y.y);
      update<KIND>(a.z, b.z, c.z, eta, beta, x.z, y.z);
      update<KIND>(a.w, b.w, c.w, eta, beta, x.w, y.w);
      wo4[i] = x;
      so4[i] = y;
    }
    start = n4 * 4;
  }
  for (int64_t i = start + tid; i < n; i += stride) {
    update<KIND>(w[i], s[i], d[i], eta, beta, w_out[i], s_out[i]);
  }
}

template <int KIND>
void launch(const float* w, const float* s, const float* d, float* w_out,
            float* s_out, int64_t n, float eta, float beta,
            cudaStream_t stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(w) |
                     reinterpret_cast<uintptr_t>(s) |
                     reinterpret_cast<uintptr_t>(d) |
                     reinterpret_cast<uintptr_t>(w_out) |
                     reinterpret_cast<uintptr_t>(s_out)) & 15) == 0;
  const int64_t items = vec ? (n + 3) / 4 : n;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  if (vec) {
    fedmom_update_kernel<KIND, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        w, s, d, w_out, s_out, n, eta, beta);
  } else {
    fedmom_update_kernel<KIND, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        w, s, d, w_out, s_out, n, eta, beta);
  }
}

}  // namespace

extern "C" int fedmom_update_launch(const float* w, const float* s,
                                    const float* d, float* w_out,
                                    float* s_out, long long n, int kind,
                                    float eta, float beta, void* stream) {
  if (n < 0 || (kind != kFedMom && kind != kFedAvgM)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (kind == kFedMom) {
      launch<kFedMom>(w, s, d, w_out, s_out, (int64_t)n, eta, beta, st);
    } else {
      launch<kFedAvgM>(w, s, d, w_out, s_out, (int64_t)n, eta, beta, st);
    }
  }
  return (int)cudaGetLastError();
}
