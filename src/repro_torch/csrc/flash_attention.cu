// Causal / sliding-window flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py:94
// (flash_attention_bhsd; body _kernel :32), which ops.py reaches after
// repeating K/V to every query head.
//
// For each batch b, query head h and query position i (KV head
// hk = h / (Hq/Hkv)):
//   s_j   = (q[b,i,h,:] . k[b,j,hk,:]) * scale          scale = 1/sqrt(d)
//   keep  = (!causal || j <= i) && (window <= 0 || j > i - window)
//   out[b,i,h,:] = sum_j softmax_j(s | keep) v[b,j,hk,:]
// with an online softmax (running max m and sum l in fp32) and fp32
// accumulation, written in the input dtype.  Masked scores drop out with
// probability exactly 0, as in the TPU kernel (there a score of -1e30); a
// row that keeps nothing (l == 0) is divided by 1, giving 0, not NaN.
//
// Two kernels:
//
// * tc::flash_fwd<D>, bf16 (the serving path).  What bounds it: 4*d flops
//   per kept (query, key) pair on the tensor cores against q, k, v and out
//   moved once.  At gemma3-1b's prefill (B=8, S=1024, 4 query heads over 1
//   KV head, d=256, window 512 or none) that is 0.0137 ms of operations at
//   989 TFLOP/s against 0.0125 ms of bytes at 3.35 TB/s; at
//   recurrentgemma-9b's (B=8, S=4096, 16 over 1, d=256, window 2048) 0.834
//   ms of operations against 0.17 ms of bytes.  Both are bound by the
//   tensor cores, so the design is about keeping them fed:
//   - products on the tensor cores: S = Q.K^T is a wgmma m64n64k16 per 16
//     columns of d (Q and K from shared memory, 128-byte-swizzled K-major,
//     fp32 accumulator; bf16 x bf16 products are exact in fp32), and O +=
//     P.V a register-A wgmma m64n64k16 per 64 columns of d, V read from
//     shared memory transposed (MN-major).  P is split into bf16 hi + lo
//     parts (hi = bf16(p), lo = bf16(p - hi)), two wgmmas into the same
//     fp32 accumulator, so P keeps ~16 bits, not bf16's 8: with P rounded
//     once to bf16, as FlashAttention-3 does, outputs moved by a bf16 ulp
//     of values in [2, 4) (1.56e-2 against the plain version's fp32
//     probabilities, above the 1e-2 this design allows itself under the
//     reference's 2e-2); the split doubles P.V, half again the kernel's
//     tensor-core work.  The one-part design stays reachable as a
//     yardstick;
//   - tiles stay bf16 in shared memory as TMA wrote them, 128-byte
//     swizzled (no widening to fp32): Q 64 KB plus two K/V stages of 64 KB
//     at d = 256, 193 KB in all;
//   - one producer warp issues TMA loads (cp.async.bulk.tensor, 4-D maps
//     over [B, S, H, d], four 64-column boxes a row at d = 256) into a ring
//     of 2 K/V stages on mbarriers, so the next tiles' loads run under the
//     current tile's wgmmas; K and V have barriers of their own (K is free
//     once S is computed, V only after P.V), and the consumers release
//     each with one arrive a warp; no __syncthreads in the loop;
//   - the tensor cores are kept busy while a warpgroup runs its softmax:
//     each step issues S of tile j and P.V of tile j-1 together and runs
//     tile j's softmax under that P.V (FlashAttention-3's overlap within a
//     warpgroup; the first and last steps are peeled, since ptxas
//     serializes every wgmma of a kernel that issues one under a branch),
//     and the two warpgroups take turns to issue (pingpong on named
//     barriers), so one's softmax also runs under the other's wgmmas;
//   - rows of a 128-row Q tile are (position, query head) pairs of one KV
//     head: 128/Gp positions x Gp heads, Gp = gcd(Hq/Hkv, 64) (32 x 4 for
//     gemma3-1b, 8 x 16 for recurrentgemma-9b; a group size with no such
//     factor packs fewer heads, down to one), so each K/V tile is loaded
//     once for all Gp heads; a row's masks use its position p0 + row / Gp;
//   - P never leaves the registers: the S accumulator's layout is the A
//     fragment layout of the P.V wgmma.
//   Two consumer warpgroups take 64 rows each (setmaxnreg moves registers
//   from the producer warpgroup to them: 128 fp32 of O, 32 of S and 32 of
//   P a thread at d = 256); one block of three warpgroups an SM.  The output goes through the warpgroup's own half
//   of the Q tile in shared memory to one TMA store a 64-column box; a
//   partial last tile is zero-filled on load and clipped on store.
//   Raw PTX (wgmma, TMA, mbarrier), not CuTe: the file builds in seconds
//   with a plain C interface, no CUTLASS include path needed.
//
// * simt::flash_fwd<T, D>, the first kernel (fp32 products on the CUDA
//   cores, one 16-warp block per (b, h, 64-row q tile), K/V widened to fp32
//   in shared memory).  It serves fp32 inputs: TF32 tensor cores could not
//   hold the fp32 tolerance of 2e-5.  Its bf16 instantiation is on no
//   path: a yardstick that chip_smoke.py times beside the tensor-core
//   kernel.
//
// Both skip whole key tiles above the causal diagonal or older than the
// window (the TPU kernel's pl.when skips), from the tile's first and last
// positions, and run the latest q tiles first.  Supported: d in {64, 128,
// 256}, S = T, S a multiple of 64, Hq a multiple of Hkv.
//
// Rounding: sums run in another order than the plain version
// (kernels/flash_attention/ref.py, a dense masked fp32 softmax); the bf16
// kernel also carries P in two bf16 parts into P.V.  The two agree within
// the reference's tolerances (fp32 2e-5, bf16 2e-2), not bit for bit.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).  The tensor
// maps are built on the host at each launch and passed by value
// (__grid_constant__), so a captured CUDA graph replays them as they were.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kSMultiple = 64;             // S must be a multiple of this

// ---------------------------------------------------------------------------
// simt: fp32 products on the CUDA cores (fp32 inputs; bf16 only as a
// yardstick)
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kWarps = 16;
constexpr int kRows = 4;                    // query rows per warp
constexpr int kBlockQ = kWarps * kRows;     // 64 query rows per block
constexpr int kBlockK = 64;                 // keys per tile
constexpr int kThreads = kWarps * 32;

template <int D>
__host__ __device__ constexpr int k_stride() {
  return D + 4;                             // floats per K row in smem
}

template <int D>
__host__ __device__ constexpr size_t smem_floats() {
  return size_t(kBlockK) * k_stride<D>()   // K tile (padded rows)
         + size_t(kBlockK) * D             // V tile
         + size_t(kBlockQ) * D             // Q tile
         + size_t(kBlockQ) * kBlockK;      // probabilities
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes of the input dtype -> fp32 in shared memory.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* src, float* dst) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  }
  __device__ static float out(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* src, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    const float2 c = __bfloat1622float2(h[2]);
    const float2 d = __bfloat1622float2(h[3]);
    reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
    reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
  }
  __device__ static __nv_bfloat16 out(float x) { return __float2bfloat16(x); }
};

// rows x D elements, rows row_stride elements apart -> fp32 rows dst_stride
// floats apart in shared memory; the whole block takes part.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          int64_t row_stride, int rows,
                                          float* dst, int dst_stride) {
  constexpr int N = Vec<T>::N;
  constexpr int kPerRow = D / N;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * N;
    Vec<T>::load(src + r * row_stride + c, dst + r * dst_stride + c);
  }
}

// One block of 16 warps per (b, h, 64-row q tile); each warp owns 4 query
// rows (lane c holds columns c, c+32, ...); K/V tiles of 64 keys staged in
// shared memory as fp32 (K rows padded by 4 floats against bank conflicts).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int Hq, int Hkv,
          int n_qt, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int KS = k_stride<D>();
  constexpr int kCols = D / 32;
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kBlockK * KS;
  float* qs = vs + kBlockK * D;
  float* ps = qs + kBlockQ * D;

  const int bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - (blockIdx.x - bh * n_qt);   // latest tiles first
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBlockQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = q0 + warp * kRows;                   // this warp's rows

  const int64_t q_stride = int64_t(Hq) * D;             // [B, S, Hq, D]
  const int64_t kv_stride = int64_t(Hkv) * D;           // [B, S, Hkv, D]
  const T* q_base = q + (int64_t(b) * S + q0) * q_stride + int64_t(h) * D;
  const T* k_base = k + int64_t(b) * S * kv_stride + int64_t(hk) * D;
  const T* v_base = v + int64_t(b) * S * kv_stride + int64_t(hk) * D;

  load_rows<T, D>(q_base, q_stride, kBlockQ, qs, D);

  // k tiles that hold a kept key for some row of this block
  int kt_lo = 0;
  int kt_hi = S / kBlockK;
  if (causal) kt_hi = min(kt_hi, (q0 + kBlockQ - 1) / kBlockK + 1);
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / kBlockK;

  float acc[kRows][kCols];
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  const float4* q4 = reinterpret_cast<const float4*>(qs + warp * kRows * D);
  float* prow = ps + warp * kRows * kBlockK;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();        // the previous tile's readers are done
    load_rows<T, D>(k_base + k0 * kv_stride, kv_stride, kBlockK, ks, KS);
    load_rows<T, D>(v_base + k0 * kv_stride, kv_stride, kBlockK, vs, D);
    __syncthreads();

    // scores of keys k0 + lane and k0 + lane + 32 against the warp's rows
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float4* ka = reinterpret_cast<const float4*>(ks + lane * KS);
    const float4* kb = reinterpret_cast<const float4*>(ks + (lane + 32) * KS);
#pragma unroll 4
    for (int c = 0; c < D / 4; ++c) {
      const float4 a = ka[c];
      const float4 bb = kb[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 x = q4[r * (D / 4) + c];
        s[r][0] = fmaf(x.x, a.x, s[r][0]);
        s[r][0] = fmaf(x.y, a.y, s[r][0]);
        s[r][0] = fmaf(x.z, a.z, s[r][0]);
        s[r][0] = fmaf(x.w, a.w, s[r][0]);
        s[r][1] = fmaf(x.x, bb.x, s[r][1]);
        s[r][1] = fmaf(x.y, bb.y, s[r][1]);
        s[r][1] = fmaf(x.z, bb.z, s[r][1]);
        s[r][1] = fmaf(x.w, bb.w, s[r][1]);
      }
    }

    float alpha[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = row0 + r;
      const int ja = k0 + lane;
      const int jb = k0 + lane + 32;
      bool keep_a = true, keep_b = true;
      if (causal) {
        keep_a = ja <= i;
        keep_b = jb <= i;
      }
      if (window > 0) {
        keep_a = keep_a && ja > i - window;
        keep_b = keep_b && jb > i - window;
      }
      const float sa = keep_a ? s[r][0] * scale : kNegInf;
      const float sb = keep_b ? s[r][1] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sa, sb)));
      const float pa = keep_a ? expf(sa - m_new) : 0.f;
      const float pb = keep_b ? expf(sb - m_new) : 0.f;
      alpha[r] = expf(m[r] - m_new);
      l[r] = alpha[r] * l[r] + warp_sum(pa + pb);
      m[r] = m_new;
      prow[r * kBlockK + lane] = pa;
      prow[r * kBlockK + lane + 32] = pb;
    }
    __syncwarp();

#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha[r];
#pragma unroll 2
    for (int j = 0; j < kBlockK; ++j) {
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) p[r] = prow[r * kBlockK + j];
      const float* vr = vs + j * D + lane;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float x = vr[32 * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(p[r], x, acc[r][c]);
      }
    }
    __syncwarp();           // prow is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float denom = l[r] == 0.f ? 1.f : l[r];
    T* orow = o + (int64_t(b) * S + row0 + r) * q_stride + int64_t(h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      orow[lane + 32 * c] = Vec<T>::out(acc[r][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Hq, int Hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const int n_qt = S / kBlockQ;
  const long long blocks = (long long)B * Hq * n_qt;
  if (blocks > INT_MAX) return int(cudaErrorInvalidConfiguration);
  flash_fwd<T, D><<<unsigned(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Hq, Hkv, n_qt, causal,
      window, scale);
  return int(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// tc: bf16 on the tensor cores (wgmma), fed by TMA
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kRows = 128;                 // rows of a Q tile
constexpr int kKeys = 64;                  // keys of a K/V tile
constexpr int kStages = 2;                 // K/V ring
constexpr int kThreads = 384;              // consumers: warpgroups 0, 1
constexpr int kHalfBytes = 64 * 128;       // 64 rows x one 128-byte row
constexpr int kKvChunkBytes = kKeys * 128; // 64 keys x 64 bf16 columns

template <int D>
struct Layout {
  static constexpr int kChunks = D / 64;   // 64-column boxes of a row
  // Q (then O): [chunk][warpgroup][64 rows][128 B]
  static constexpr int q_bytes = kChunks * 2 * kHalfBytes;
  // one K or V tile: [chunk][64 keys][128 B]
  static constexpr int kv_bytes = kChunks * kKvChunkBytes;
  static constexpr int stage_bytes = 2 * kv_bytes;           // K then V
  static constexpr int bar_offset = q_bytes + kStages * stage_bytes;
  static constexpr int smem_bytes = bar_offset + 128 + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The registers the wgmmas wrote asynchronously are read only after this.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The A fragments a wgmma read asynchronously stay untouched until this.
__device__ __forceinline__ void fence_u32(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define WG_ACC32                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define WG_REGS32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared
// memory; accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (bf16 pairs in
// the accumulator's layout), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_ACC32
#undef WG_REGS32

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x0, x1) -> bf16 pairs hi = bf16(x) and lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - f.x, x1 - f.y);
}

__device__ __forceinline__ bool keep(int pos, int key, int causal,
                                     int window) {
  return (!causal || key <= pos) && (window <= 0 || key > pos - window);
}

// One block per (128/Gp positions, Gp query heads of one KV head, b).
// Rows r of the Q tile: position p0 + r / Gp, query head h0 + r % Gp.
// kParts: P carried into P.V in 1 (bf16) or 2 (bf16 hi + lo) parts.
template <int D, int kParts>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const __grid_constant__ CUtensorMap tm_o, int S, int Hkv, int G,
          int Gp, int n_qt, int n_rest, int causal, int window,
          float scale_log2) {
  using L = Layout<D>;
  constexpr int kChunks = L::kChunks;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes: align the base to them
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_kv = base + L::q_bytes;
  // mbarriers, 8 bytes each: Q loaded; per stage, K and V loaded (full)
  // and released by the consumers (empty)
  const uint32_t bar_q = base + L::bar_offset;
  const uint32_t full_k = bar_q + 8;                   // + 8 * stage
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;

  const int order = blockIdx.x / n_rest;
  const int qt = n_qt - 1 - order;                     // latest tiles first
  int rest = blockIdx.x - order * n_rest;
  const int n_sub = G / Gp;
  const int gi = rest % n_sub;
  rest /= n_sub;
  const int hk = rest % Hkv;
  const int b = rest / Hkv;
  const int P = kRows / Gp;                            // positions a tile
  const int p0 = qt * P;
  const int h0 = hk * G + gi * Gp;
  const int p_last = min(p0 + P, S) - 1;
  // key tiles that hold a kept key for some row of this tile
  int kt_hi = S / kKeys;
  if (causal) kt_hi = min(kt_hi, p_last / kKeys + 1);
  const int kt_lo =
      (window > 0 && p0 - window + 1 > 0) ? (p0 - window + 1) / kKeys : 0;
  const int n_tiles = max(0, kt_hi - kt_lo);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty_k + 8 * st, 8);     // one arrive per consumer warp
      mbar_init(empty_v + 8 * st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, L::q_bytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          tma_load(s_q + (2 * c + h) * kHalfBytes, &tm_q, bar_q, 64 * c, h0,
                   p0 + h * (P / 2), b);
      // K of a tile is released once its S is computed, V once its P.V
      // is (a step later), so the rings of K and V run apart
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const uint32_t parity = ((it / kStages) - 1) & 1;
        const int k0 = (kt_hi - 1 - it) * kKeys;
        const uint32_t s_k = s_kv + st * L::stage_bytes;
        if (it >= kStages) mbar_wait(empty_k + 8 * st, parity);
        mbar_expect_tx(full_k + 8 * st, L::kv_bytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load(s_k + c * kKvChunkBytes, &tm_k, full_k + 8 * st, 64 * c,
                   hk, k0, b);
        if (it >= kStages) mbar_wait(empty_v + 8 * st, parity);
        mbar_expect_tx(full_v + 8 * st, L::kv_bytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load(s_k + L::kv_bytes + c * kKvChunkBytes, &tm_v,
                   full_v + 8 * st, 64 * c, hk, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 rows a warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int ra = (t >> 5) * 16 + (lane >> 2);   // rows ra and ra + 8
    const int pos_a = p0 + (wg * 64 + ra) / Gp;
    const int pos_b = p0 + (wg * 64 + ra + 8) / Gp;
    const uint32_t s_qw = s_q + wg * kHalfBytes;

    float o[kChunks][32];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf;   // running max, log2 units
    float l_a = 0.f, l_b = 0.f;           // this thread's share of the sum

    // Step `it` issues S = Q.K^T of tile it and P.V of tile it - 1 (whose
    // P the step before computed), then runs tile it's softmax while that
    // P.V runs (FlashAttention-3's overlap within a warpgroup); the first
    // and last steps are peeled, so no wgmma sits under a branch (ptxas
    // serializes those).  Pingpong: the warpgroups take turns to issue
    // (named barriers 3 + wg, both warpgroups' 256 threads), so one's
    // softmax runs under the other's wgmmas; warpgroup 0 goes first.
    uint32_t pk[4][4], pl[4][4];          // P of the previous tile: hi, lo
    float al_a = 1.f, al_b = 1.f;         // its rescale of O, not yet applied
    float s[32];

    // S = Q . K^T of tile it: 16 columns of d a step, K-major, 32 B apart
    // inside a swizzle atom
    auto issue_s = [&](int it) {
      const int st = it % kStages;
      const uint32_t s_k = s_kv + st * L::stage_bytes;
      mbar_wait(full_k + 8 * st, (it / kStages) & 1);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = sw128_desc(
            s_qw + (kk >> 2) * 2 * kHalfBytes + (kk & 3) * 32, 16, 1024);
        const uint64_t db = sw128_desc(
            s_k + (kk >> 2) * kKvChunkBytes + (kk & 3) * 32, 16, 1024);
        wgmma_ss(s, da, db, kk > 0);
      }
      wgmma_commit();
      fence_regs(s);
    };
    // O = alpha O + P . V of tile it: V is [64 keys][64 columns] a chunk,
    // MN-major; 16 keys (two 8-row groups, 2048 B) a step
    auto issue_pv = [&](int it) {
      const int st = it % kStages;
      const uint32_t s_v = s_kv + st * L::stage_bytes + L::kv_bytes;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[c][4 * j] *= al_a;
          o[c][4 * j + 1] *= al_a;
          o[c][4 * j + 2] *= al_b;
          o[c][4 * j + 3] *= al_b;
        }
      mbar_wait(full_v + 8 * st, (it / kStages) & 1);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) fence_regs(o[c]);
      fence_u32(pk);
      fence_u32(pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const uint64_t dv = sw128_desc(s_v + c * kKvChunkBytes + kk * 2048,
                                         kKvChunkBytes, 1024);
          wgmma_rs(o[c], pk[kk], dv);
          if (kParts == 2) wgmma_rs(o[c], pl[kk], dv);
        }
      wgmma_commit();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) fence_regs(o[c]);
      fence_u32(pk);
      fence_u32(pl);
    };
    // once P.V of tile it is done: its A fragments and V are free
    auto pv_done = [&](int it) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) fence_regs(o[c]);
      fence_u32(pk);
      fence_u32(pl);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v + 8 * (it % kStages));
    };
    // once S of tile it is done: K is free; the online softmax turns S
    // into P (in place, fp32) and sets the rescale of O
    auto softmax = [&](int it) {
      fence_regs(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_k + 8 * (it % kStages));
      const int k0 = (kt_hi - 1 - it) * kKeys;
      // Accumulator layout: s[4j + e] is row ra, key k0 + 8j + 2(lane%4)
      // + e; s[4j + 2 + e] the same key for row ra + 8.
      const bool masked = (causal && k0 + kKeys - 1 > p0) ||
                          (window > 0 && k0 <= p_last - window);
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float xa = s[4 * j + e] * scale_log2;
          float xb = s[4 * j + 2 + e] * scale_log2;
          if (masked) {
            const int key = k0 + 8 * j + 2 * (lane & 3) + e;
            if (!keep(pos_a, key, causal, window)) xa = -INFINITY;
            if (!keep(pos_b, key, causal, window)) xb = -INFINITY;
          }
          s[4 * j + e] = xa;
          s[4 * j + 2 + e] = xb;
          mx_a = fmaxf(mx_a, xa);
          mx_b = fmaxf(mx_b, xb);
        }
      // the four threads of a quad hold one row
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      al_a = fast_exp2(m_a - mn_a);
      al_b = fast_exp2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      // P = exp2(S - m) (a masked score is -inf: exactly 0)
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = fast_exp2(s[4 * j + e] - mn_a);
          s[4 * j + 2 + e] = fast_exp2(s[4 * j + 2 + e] - mn_b);
          sum_a += s[4 * j + e];
          sum_b += s[4 * j + 2 + e];
        }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
    };
    // P packed to bf16 as the A fragments of four k16 steps of P.V
    auto pack = [&]() {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t* hi = pk[j >> 1] + 2 * (j & 1);
        uint32_t* lo = pl[j >> 1] + 2 * (j & 1);
        if (kParts == 2) {
          split_bf16(s[4 * j], s[4 * j + 1], hi[0], lo[0]);
          split_bf16(s[4 * j + 2], s[4 * j + 3], hi[1], lo[1]);
        } else {
          hi[0] = pack_bf16(s[4 * j], s[4 * j + 1]);
          hi[1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
          lo[0] = lo[1] = 0u;
        }
      }
    };
    auto my_turn = [&]() {
      asm volatile("bar.sync %0, 256;\n" :: "r"(3 + wg) : "memory");
    };
    auto your_turn = [&]() {
      asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - wg) : "memory");
    };

    mbar_wait(bar_q, 0);
    if (n_tiles > 0) {
      if (wg == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
      my_turn();
      issue_s(0);
      your_turn();
      wgmma_wait_all();
      softmax(0);
      pack();
      for (int it = 1; it < n_tiles; ++it) {
        my_turn();
        issue_s(it);
        issue_pv(it - 1);
        your_turn();
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        softmax(it);
        wgmma_wait_all();
        pv_done(it - 1);
        pack();
      }
      my_turn();
      issue_pv(n_tiles - 1);
      if (wg == 0) your_turn();
      wgmma_wait_all();
      pv_done(n_tiles - 1);
    }

    // Epilogue: O / l in bf16 into this warpgroup's half of the Q tile
    // (only this warpgroup read it), in the same 128-byte swizzle, then one
    // TMA store a chunk.
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
    const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const uint32_t row_a = s_qw + c * 2 * kHalfBytes + ra * 128;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t col = ((j ^ (ra & 7)) << 4) + (lane & 3) * 4;
        const uint32_t va = pack_bf16(o[c][4 * j] * inv_a,
                                      o[c][4 * j + 1] * inv_a);
        const uint32_t vb = pack_bf16(o[c][4 * j + 2] * inv_b,
                                      o[c][4 * j + 3] * inv_b);
        asm volatile("st.shared.b32 [%0], %1;\n"
                     :: "r"(row_a + col), "r"(va) : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n"
                     :: "r"(row_a + 8 * 128 + col), "r"(vb) : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        tma_store(&tm_o, s_qw + c * 2 * kHalfBytes, 64 * c, h0,
                  p0 + wg * (P / 2), b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's encoder, looked up in the driver library the CUDA runtime
// has already loaded (no link against libcuda).
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A 4-D map over a contiguous bf16 [B, S, heads, d] tensor (innermost
// first), boxes of 64 columns x box_heads heads x box_rows positions,
// 128-byte swizzle, zero fill past the edges.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int d, int box_heads, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(d) * 2,
                                 cuuint64_t(heads) * d * 2,
                                 cuuint64_t(S) * heads * d * 2};
  const cuuint32_t box[4] = {64, cuuint32_t(box_heads), cuuint32_t(box_rows),
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

template <int D, int kParts>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Hq, int Hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int Gp = gcd(G, 64);               // heads packed into a tile
  const int P = kRows / Gp;                // positions a tile
  const int n_qt = (S + P - 1) / P;
  const long long n_rest = (long long)B * Hkv * (G / Gp);
  const long long blocks = n_rest * n_qt;
  if (blocks > INT_MAX) return int(cudaErrorInvalidConfiguration);
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!make_map(&tm_q, q, B, S, Hq, D, Gp, P / 2) ||
      !make_map(&tm_o, o, B, S, Hq, D, Gp, P / 2) ||
      !make_map(&tm_k, k, B, S, Hkv, D, 1, kKeys) ||
      !make_map(&tm_v, v, B, S, Hkv, D, 1, kKeys))
    return int(cudaErrorInvalidValue);
  const int smem = Layout<D>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D, kParts>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  flash_fwd<D, kParts><<<unsigned(blocks), kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_o, S, Hkv, G, Gp, n_qt, int(n_rest), causal,
      window, scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

}  // namespace tc

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Hq, int Hkv, int d, int causal, int window,
                float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return simt::launch<T, 64>(q, k, v, o, B, S, Hq, Hkv, causal, window,
                                 scale, stream);
    case 128:
      return simt::launch<T, 128>(q, k, v, o, B, S, Hq, Hkv, causal, window,
                                  scale, stream);
    case 256:
      return simt::launch<T, 256>(q, k, v, o, B, S, Hq, Hkv, causal, window,
                                  scale, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <int kParts>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int Hq, int Hkv, int d, int causal, int window,
              float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return tc::launch<64, kParts>(q, k, v, o, B, S, Hq, Hkv, causal, window,
                                    scale, stream);
    case 128:
      return tc::launch<128, kParts>(q, k, v, o, B, S, Hq, Hkv, causal,
                                     window, scale, stream);
    case 256:
      return tc::launch<256, kParts>(q, k, v, o, B, S, Hq, Hkv, causal,
                                     window, scale, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

bool valid(int B, int S, int Hq, int Hkv) {
  return B >= 1 && S >= kSMultiple && S % kSMultiple == 0 && Hq >= 1 &&
         Hkv >= 1 && Hq % Hkv == 0;
}

}  // namespace

extern "C" {

// S must be a multiple of this (the CUDA-core kernel's query and key
// tiles; the tensor-core kernel's key tile).
int flash_attention_s_multiple() { return kSMultiple; }

// q, o: [B, S, Hq, d]; k, v: [B, S, Hkv, d]; contiguous, 16-byte aligned,
// one dtype (0 = fp32, 1 = bf16).  Hq % Hkv == 0, S % 64 == 0.  design:
//   0  the CUDA-core kernel (either dtype; the path's for fp32);
//   1  the tensor-core kernel with P in one bf16 part (bf16 only);
//   2  the tensor-core kernel with P in bf16 hi + lo parts (bf16 only; the
//      path's for bf16).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int S, int Hq, int Hkv,
                           int d, int causal, int window, float scale,
                           void* stream, int design) {
  if (!valid(B, S, Hq, Hkv)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 0 && dtype == 0)
    return launch_simt<float>(q, k, v, o, B, S, Hq, Hkv, d, causal, window,
                              scale, s);
  if (design == 0 && dtype == 1)
    return launch_simt<__nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv, d, causal,
                                      window, scale, s);
  if (design == 1 && dtype == 1)
    return launch_tc<1>(q, k, v, o, B, S, Hq, Hkv, d, causal, window, scale,
                        s);
  if (design == 2 && dtype == 1)
    return launch_tc<2>(q, k, v, o, B, S, Hq, Hkv, d, causal, window, scale,
                        s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
