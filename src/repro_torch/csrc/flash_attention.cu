// Causal / sliding-window flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py:94
// (flash_attention_bhsd; body _kernel :32), which ops.py reaches after
// repeating K/V to every query head.
//
// For each batch b, query head h and query row i (KV head hk = h / (Hq/Hkv)):
//   s_j   = (q[b,i,h,:] . k[b,j,hk,:]) * scale          scale = 1/sqrt(d)
//   keep  = (!causal || j <= i) && (window <= 0 || j > i - window)
//   out[b,i,h,:] = sum_j softmax_j(s | keep) v[b,j,hk,:]
// in fp32 (online softmax with a running max m and sum l), written in the
// input dtype.  Masked scores are -1e30 and their probabilities exactly 0,
// as in the TPU kernel; a row that keeps nothing (l == 0) is divided by 1,
// giving 0, not NaN.
//
// What bounds it: the work is 4*d flops per kept (query, key) pair against
// q, k, v and out read or written once; at the serving path's shapes (S =
// 1024, d = 256, MQA) that is ~60 flops a byte in bf16, below the tensor
// cores' ridge of ~295, so at full speed memory would bound it.  This first
// kernel does its products on the CUDA cores in fp32, not on the tensor
// cores (wgmma is later work), so it runs far above either bound; chip_smoke
// prints both next to its time.
//
// Design, against the TPU kernel's grid of (BH, q tile, k tile) steps that
// carries (m, l, acc) in VMEM across the sequential k dimension:
//  * one block of 16 warps per (b, h, 64-row q tile); each warp owns 4 query
//    rows and keeps their m, l and accumulators in registers (lane c holds
//    columns c, c+32, ...), so a loop over k tiles inside the block takes
//    the place of the sequential grid dimension;
//  * K/V are read in the model's [B, T, Hkv, d] layout with the KV head
//    indexed per query head, instead of repeated Hq/Hkv times as ops.py does
//    for the TPU: 4x fewer K/V bytes for an MQA model with 4 query heads;
//  * each 64-key tile of K and V is staged once per block in shared memory
//    as fp32 (K rows padded by 4 floats, so the float4 reads of 32 lanes on
//    32 different rows hit 32 different banks); 214 KB at d = 256, above the
//    48 KB default, so the launch raises the block's limit first;
//  * a lane scores keys lane and lane+32 of the tile against each of its
//    warp's 4 rows, one warp-wide max and sum per row and tile, then the
//    probabilities go through shared memory to the P.V product;
//  * whole k tiles above the causal diagonal or older than the window are
//    never loaded (the TPU kernel's pl.when skips);
//  * blocks run the longest (latest) q tiles first.
// Supported: d in {64, 128, 256}, fp32 or bf16, S = T, S a multiple of 64.
//
// Rounding: fp32 throughout with explicit fmaf; sums run in another order
// than the plain version (kernels/flash_attention/ref.py, a dense masked
// softmax), so the two agree within fp32 (bf16: output-rounding) tolerance,
// not bit for bit.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kRows = 4;                    // query rows per warp
constexpr int kBlockQ = kWarps * kRows;     // 64 query rows per block
constexpr int kBlockK = 64;                 // keys per tile
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

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

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int S, int Hq, int Hkv, int d, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, Hq, Hkv, causal, window, scale,
                            stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Query rows per block and keys per tile: S must be a multiple of both.
int flash_attention_block_q() { return kBlockQ; }
int flash_attention_block_k() { return kBlockK; }

// q, o: [B, S, Hq, d]; k, v: [B, S, Hkv, d]; contiguous, 16-byte aligned,
// one dtype (0 = fp32, 1 = bf16).  Hq % Hkv == 0, S % 64 == 0.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int S, int Hq, int Hkv,
                           int d, int causal, int window, float scale,
                           void* stream) {
  if (B < 1 || S < kBlockQ || S % kBlockQ || S % kBlockK || Hq < 1 ||
      Hkv < 1 || Hq % Hkv)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, S, Hq, Hkv, d, causal, window,
                           scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv, d, causal,
                                   window, scale, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
