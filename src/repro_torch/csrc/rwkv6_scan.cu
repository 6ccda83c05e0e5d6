// Chunked RWKV6 (Finch) time-mix recurrence forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan/kernel.py:81
// (rwkv6_bhsd; body _kernel :35), which ops.py reaches after folding
// (batch, head) into one axis and broadcasting u to every (batch, head).
//
// For each batch b and head h, over tokens t with an fp32 state S [Dk, Dv]
// that starts at zero:
//   o_t = r_t S_{t-1} + (r_t . u . k_t) v_t
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,          w_t = exp(log_w_t)
// in fp32, o written in v's dtype.  Chunked as the TPU kernel does it: with
// L the inclusive cumulative log-decay within a chunk of C tokens,
//   o_i = (r_i * exp(L_{i-1})) S                          (inter-chunk)
//       + sum_{j<i} (sum_c r_ic k_jc exp(L_{i-1,c} - L_jc)) v_j   (intra)
//       + (r_i . u . k_i) v_i                                (bonus)
//   S'  = diag(exp(L_{C-1})) S + sum_j (k_j * exp(L_{C-1} - L_j))^T v_j
// (L_{-1} = 0).  Every exponent is <= 0, so no factor overflows for any
// decay: L is summed in token order from log_w <= 0, so it never rises,
// and the intra-chunk exponent is clamped at 0 as in the reference.  The
// pairs j >= i are never formed, so no inf * 0 = NaN can arise.
//
// What bounds it: at the forward loss path's shape (B = 8, S = 1024,
// H = 64, Dk = Dv = 64, bf16 r/k/v and o, fp32 log_w) the function moves
// ~403 MB and needs ~11 GFLOP, ~27 flops a byte, far below the tensor
// cores' ridge of ~295: at full speed memory bounds it (~120 us at
// 3.35 TB/s).  This kernel does its products on the CUDA cores in fp32
// from shared memory, with one expf per (i, j, channel) of the intra term,
// so instructions bound it, well above that bound; chip_smoke.py prints
// both.
//
// Design, against the TPU kernel's grid of (BH, chunk) steps that carries S
// in VMEM across the sequential chunk axis (Hopper's blocks run in no
// order, so nothing may carry between them):
//  * one block of 256 threads per (batch, head) walks its chunks in order
//    with S in shared memory; there is no chunk grid axis;
//  * r, k, v and log_w are read in the model's [B, S, H, D] layout and u as
//    [H, Dk], indexed per head: no transposes or broadcasts around the
//    call, where the TPU path folds to [BH, S, D] and repeats u B times;
//  * each chunk is staged as fp32 in shared memory, rows of r, k and L
//    padded by one float so that 32 lanes reading one channel of 32 rows
//    hit 32 banks; then, each step one barrier apart: L by a sequential
//    sum per channel; the C(C-1)/2 intra-chunk scores and the C bonuses
//    (one work item a thread, triangular index) into a [C][C + 1] score
//    matrix that stays 0 above its diagonal; r and k scaled by their
//    decays in place; o, then S, each a register tile of rows by 4 columns
//    a thread, so one float4 load of S or v feeds 4 to 64 fmaf;
//  * the chunk is a template parameter, so every loop bound and tile is
//    known to the compiler (54 instantiations: 2 dtypes x 3 Dk x 3 Dv x 3
//    chunks);
//  * a chunk of 32 at Dk = Dv = 64 takes 53 KB of shared memory, so four
//    blocks share an SM; Dk = Dv = 128 at chunk 64 takes 214 KB, above the
//    48 KB default, so the launch raises the block's limit first.
// Supported: Dk, Dv in {32, 64, 128}, chunk in {16, 32, 64} dividing S,
// r/k/v fp32 or bf16 (one dtype), log_w and u fp32.
//
// Rounding: fp32 throughout with explicit fmaf and expf (the build passes
// --fmad=false); sums run in another order than the plain version
// (kernels/rwkv6_scan/ref.py, token by token), so the two agree within the
// reference's kernel tolerances, not bit for bit.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 4 fp32 values to 4 outputs of T (16 or 8 bytes, aligned by the caller).
__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&lo);
  raw.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}

__device__ __forceinline__ void fma4(float a, float4 b, float4& acc) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// Floats of shared memory for one block: S [DK][DV], u [DK], r, k and L
// [C][DK + 1], v [C][DV], the intra-chunk scores [C][C + 1].
template <int DK, int DV, int C>
__host__ __device__ constexpr size_t smem_floats() {
  return size_t(DK) * DV + DK + 3 * size_t(C) * (DK + 1) + size_t(C) * DV +
         size_t(C) * (C + 1);
}

template <typename T, int DK, int DV, int C>
__global__ void __launch_bounds__(kThreads)
    rwkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ lw,
              const float* __restrict__ u, T* __restrict__ o, int S, int H) {
  // o and S are computed in tiles of 4 columns: NCG column groups, NRG row
  // groups of threads, RO rows of o and RK rows of S a thread
  constexpr int NCG = DV / 4;
  constexpr int NRG = kThreads / NCG;
  constexpr int RO = (C + NRG - 1) / NRG;
  constexpr int RK = DK / NRG;
  static_assert(C % NRG == 0 || C < NRG, "rows of o split evenly");
  static_assert(DK % NRG == 0, "rows of S split evenly");
  constexpr int PK = DK + 1;              // padded row of r, k and L
  constexpr int PA = C + 1;               // padded row of the scores
  constexpr int kPairs = C * (C - 1) / 2;
  extern __shared__ float smem[];
  float* sS = smem;             // state [DK][DV]
  float* sU = sS + DK * DV;     // u of this head [DK]
  float* sR = sU + DK;          // r, then r * exp(L_{i-1})  [C][PK]
  float* sK = sR + C * PK;      // k, then k * exp(L_end - L_j)  [C][PK]
  float* sL = sK + C * PK;      // log_w, then its inclusive sum  [C][PK]
  float* sV = sL + C * PK;      // v [C][DV]
  float* sA = sV + C * DV;      // scores A_ij (j < i), bonus A_ii; 0 above

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const size_t tok_k = size_t(H) * DK;   // elements between two tokens
  const size_t tok_v = size_t(H) * DV;
  const size_t base_k = size_t(b) * S * tok_k + size_t(h) * DK;
  const size_t base_v = size_t(b) * S * tok_v + size_t(h) * DV;
  const int col4 = (tid % NCG) * 4;      // this thread's 4 columns
  const int rg = tid / NCG;              // and its row group

  for (int idx = tid; idx < DK * DV; idx += kThreads) sS[idx] = 0.f;
  for (int idx = tid; idx < C * PA; idx += kThreads) sA[idx] = 0.f;
  for (int c = tid; c < DK; c += kThreads) sU[c] = u[size_t(h) * DK + c];

  for (int c0 = 0; c0 < S; c0 += C) {
    // 1. stage the chunk as fp32
    for (int idx = tid; idx < C * DK; idx += kThreads) {
      const int i = idx / DK, c = idx % DK;
      const size_t g = base_k + size_t(c0 + i) * tok_k + c;
      sR[i * PK + c] = to_f32(r[g]);
      sK[i * PK + c] = to_f32(k[g]);
      sL[i * PK + c] = lw[g];
    }
    for (int idx = tid; idx < C * DV; idx += kThreads) {
      const int i = idx / DV, c = idx % DV;
      sV[i * DV + c] = to_f32(v[base_v + size_t(c0 + i) * tok_v + c]);
    }
    __syncthreads();

    // 2. inclusive cumulative log-decay, in token order per channel
    for (int c = tid; c < DK; c += kThreads) {
      float acc = 0.f;
      for (int i = 0; i < C; ++i) {
        acc += sL[i * PK + c];
        sL[i * PK + c] = acc;
      }
    }
    __syncthreads();

    // 3. the intra-chunk scores of the pairs j < i (pair p of row i is
    //    p - i(i-1)/2), then the C bonuses on the diagonal
    for (int p = tid; p < kPairs + C; p += kThreads) {
      if (p < kPairs) {
        int i = (1 + int(sqrtf(8.f * float(p) + 1.f))) / 2;
        while (i * (i - 1) / 2 > p) --i;
        while (i * (i + 1) / 2 <= p) ++i;
        const int j = p - i * (i - 1) / 2;
        const float* ri = sR + i * PK;
        const float* li = sL + (i - 1) * PK;   // L_{i-1}: exclusive of row i
        const float* kj = sK + j * PK;
        const float* lj = sL + j * PK;
        float acc = 0.f;
#pragma unroll 8
        for (int c = 0; c < DK; ++c)
          acc = fmaf(ri[c] * kj[c], expf(fminf(li[c] - lj[c], 0.f)), acc);
        sA[i * PA + j] = acc;
      } else {
        const int i = p - kPairs;
        const float* ri = sR + i * PK;
        const float* ki = sK + i * PK;
        float acc = 0.f;
#pragma unroll 8
        for (int c = 0; c < DK; ++c) acc = fmaf(ri[c] * sU[c], ki[c], acc);
        sA[i * PA + i] = acc;
      }
    }
    __syncthreads();

    // 4. decays into r and k, in place: r_i * exp(L_{i-1}) for the
    //    inter-chunk product, k_j * exp(L_end - L_j) for the state update
    for (int idx = tid; idx < C * DK; idx += kThreads) {
      const int i = idx / DK, c = idx % DK;
      const float prev = i ? sL[(i - 1) * PK + c] : 0.f;
      sR[i * PK + c] *= expf(prev);
      sK[i * PK + c] *= expf(sL[(C - 1) * PK + c] - sL[i * PK + c]);
    }
    __syncthreads();

    // 5. o_i = r~_i S + sum_{j<=i} A_ij v_j, a tile of RO rows (strided by
    //    NRG) by 4 columns a thread; A is 0 above the diagonal
    if (rg < C) {
      float4 acc[RO];
#pragma unroll
      for (int m = 0; m < RO; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int c = 0; c < DK; ++c) {
        const float4 s4 = *reinterpret_cast<const float4*>(sS + c * DV + col4);
#pragma unroll
        for (int m = 0; m < RO; ++m) fma4(sR[(rg + m * NRG) * PK + c], s4,
                                          acc[m]);
      }
      const int last = rg + (RO - 1) * NRG;
      for (int j = 0; j <= last; ++j) {
        const float4 v4 = *reinterpret_cast<const float4*>(sV + j * DV + col4);
#pragma unroll
        for (int m = 0; m < RO; ++m) fma4(sA[(rg + m * NRG) * PA + j], v4,
                                          acc[m]);
      }
#pragma unroll
      for (int m = 0; m < RO; ++m)
        store4(o + base_v + size_t(c0 + rg + m * NRG) * tok_v + col4,
               acc[m]);
    }
    __syncthreads();

    // 6. S = diag(exp(L_end)) S + sum_j k~_j^T v_j, a tile of RK rows
    //    (strided by NRG) by 4 columns a thread
    {
      float4 acc[RK];
#pragma unroll
      for (int m = 0; m < RK; ++m) {
        const int c = rg + m * NRG;
        const float d = expf(sL[(C - 1) * PK + c]);
        const float4 s4 = *reinterpret_cast<const float4*>(sS + c * DV + col4);
        acc[m] = make_float4(s4.x * d, s4.y * d, s4.z * d, s4.w * d);
      }
#pragma unroll 4
      for (int j = 0; j < C; ++j) {
        const float4 v4 = *reinterpret_cast<const float4*>(sV + j * DV + col4);
#pragma unroll
        for (int m = 0; m < RK; ++m) fma4(sK[j * PK + rg + m * NRG], v4,
                                          acc[m]);
      }
#pragma unroll
      for (int m = 0; m < RK; ++m)
        *reinterpret_cast<float4*>(sS + (rg + m * NRG) * DV + col4) = acc[m];
    }
    __syncthreads();
  }
}

template <typename T, int DK, int DV, int C>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const float* u, void* o, int B, int S, int H,
           cudaStream_t stream) {
  const size_t smem = smem_floats<DK, DV, C>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_fwd<T, DK, DV, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (long long)B * H;
  if (blocks > INT_MAX) return int(cudaErrorInvalidConfiguration);
  rwkv6_fwd<T, DK, DV, C><<<unsigned(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), lw, u, static_cast<T*>(o), S, H);
  return int(cudaGetLastError());
}

template <typename T, int DK, int DV>
int launch_c(const void* r, const void* k, const void* v, const float* lw,
             const float* u, void* o, int B, int S, int H, int C,
             cudaStream_t s) {
  switch (C) {
    case 16:
      return launch<T, DK, DV, 16>(r, k, v, lw, u, o, B, S, H, s);
    case 32:
      return launch<T, DK, DV, 32>(r, k, v, lw, u, o, B, S, H, s);
    case 64:
      return launch<T, DK, DV, 64>(r, k, v, lw, u, o, B, S, H, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename T, int DK>
int launch_dv(const void* r, const void* k, const void* v, const float* lw,
              const float* u, void* o, int B, int S, int H, int Dv, int C,
              cudaStream_t s) {
  switch (Dv) {
    case 32:
      return launch_c<T, DK, 32>(r, k, v, lw, u, o, B, S, H, C, s);
    case 64:
      return launch_c<T, DK, 64>(r, k, v, lw, u, o, B, S, H, C, s);
    case 128:
      return launch_c<T, DK, 128>(r, k, v, lw, u, o, B, S, H, C, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_dk(const void* r, const void* k, const void* v, const float* lw,
              const float* u, void* o, int B, int S, int H, int Dk, int Dv,
              int C, cudaStream_t s) {
  switch (Dk) {
    case 32:
      return launch_dv<T, 32>(r, k, v, lw, u, o, B, S, H, Dv, C, s);
    case 64:
      return launch_dv<T, 64>(r, k, v, lw, u, o, B, S, H, Dv, C, s);
    case 128:
      return launch_dv<T, 128>(r, k, v, lw, u, o, B, S, H, Dv, C, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// r, k, log_w: [B, S, H, Dk]; v, o: [B, S, H, Dv]; u: [H, Dk]; contiguous.
// r, k, v, o in one dtype (0 = fp32, 1 = bf16); log_w and u fp32.
// Dk, Dv in {32, 64, 128}; chunk in {16, 32, 64}, S a positive multiple.
int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                      const void* log_w, const void* u, void* o, int dtype,
                      int B, int S, int H, int Dk, int Dv, int chunk,
                      void* stream) {
  if (B < 1 || H < 1 || S < 1 ||
      (chunk != 16 && chunk != 32 && chunk != 64) || S % chunk)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lw = static_cast<const float*>(log_w);
  const float* uf = static_cast<const float*>(u);
  if (dtype == 0)
    return launch_dk<float>(r, k, v, lw, uf, o, B, S, H, Dk, Dv, chunk, s);
  if (dtype == 1)
    return launch_dk<__nv_bfloat16>(r, k, v, lw, uf, o, B, S, H, Dk, Dv,
                                    chunk, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
