// RG-LRU linear recurrence forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan/kernel.py:50
// (rglru_bsr; body _kernel :30), which the JAX package reaches through its
// wrapper repro/kernels/rglru_scan/ops.py:14 (rglru_scan).
//
// For every channel (b, r) of a and b [B, S, R] fp32, from h_{-1} = 0:
//   h_t = a_t * h_{t-1} + b_t,        written to h [B, S, R] fp32.
//
// What bounds it: each element is read once from a and once from b and
// written once to h, 12 bytes for 2 flops, so device memory is the only
// roofline term.  At recurrentgemma-9b's widths (B = 8, S = 4096,
// R = 4096) that is 1.61 GB, 0.481 ms at 3.35 TB/s; the 0.27 GFLOP take a
// few microseconds.  chip_smoke.py prints both.
//
// Design, against the TPU kernel's grid of (B, S / chunk) steps that
// carries the [R] state in VMEM across its sequential chunk axis and walks
// the chunk's rows with a fori_loop (Hopper's blocks run in no order, so
// nothing may carry between them):
//  * the parallelism is the B * R independent channels (32,768 at the
//    widths above): one thread per channel walks all S steps with h in a
//    register, so no block waits on another and no state leaves the SM;
//  * neighbouring threads take neighbouring r, so each step's loads of a_t
//    and b_t and the store of h_t are one 128-byte line per warp;
//  * the loads do not depend on h: each thread issues the next tile's
//    kTile = 16 steps of loads into registers before it runs the current
//    tile's dependent chain, so 32 loads a thread are in flight (~4 MB
//    over the card at the widths above, twice what Little's law asks at
//    3.35 TB/s and ~1 us of latency);
//  * the tiles cover the largest multiple of kTile in S without a bound
//    check; the last S % kTile steps of a ragged S run one at a time.
// The reference's chunk plays no part here: every thread walks all of S.
// Supported: any 1 <= B <= 65535 and S, R >= 1.
//
// Rounding: the update is __fmul_rn then __fadd_rn, two roundings that the
// compiler never contracts into an FMA (the build also passes
// --fmad=false): the plain version (kernels/rglru_scan/ref.py) performs the
// same two operations in the same order, so the two agree bit for bit.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 16;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int S, int R) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const size_t off = (size_t)blockIdx.y * S * R + r;
  const float* ap = a + off;
  const float* bp = b + off;
  float* hp = h + off;
  const size_t step = (size_t)R;
  const int full = S - S % kTile;  // the steps in whole tiles

  float ca[kTile], cb[kTile];
  if (full > 0) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      ca[j] = ap[j * step];
      cb[j] = bp[j * step];
    }
  }
  float state = 0.0f;
  for (int t0 = 0; t0 < full; t0 += kTile) {
    // the next tile's loads, issued before this tile's dependent chain
    const bool more = t0 + kTile < full;
    float na[kTile], nb[kTile];
    if (more) {
      const size_t next = (size_t)(t0 + kTile) * step;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        na[j] = ap[next + j * step];
        nb[j] = bp[next + j * step];
      }
    }
    const size_t cur = (size_t)t0 * step;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      state = __fadd_rn(__fmul_rn(ca[j], state), cb[j]);
      hp[cur + j * step] = state;
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        ca[j] = na[j];
        cb[j] = nb[j];
      }
    }
  }
  for (int t = full; t < S; ++t) {  // the ragged tail, under kTile steps
    const size_t at = (size_t)t * step;
    state = __fadd_rn(__fmul_rn(ap[at], state), bp[at]);
    hp[at] = state;
  }
}

}  // namespace

extern "C" {

// a, b, h: [B, S, R] fp32, contiguous.
int rglru_scan_launch(const void* a, const void* b, void* h, int B, int S,
                      int R, void* stream) {
  if (B < 1 || S < 1 || R < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), S, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
