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
// in fp32, o written in v's dtype.  r, k, v and log_w are read in the
// model's [B, S, H, D] layout and u as [H, Dk], indexed per head: no
// transposes or broadcasts around the call.  One block per (batch, head)
// walks its tokens in order and carries S on the chip (Hopper's blocks run
// in no order, so nothing may carry between them; the TPU kernel carries S
// in VMEM across a sequential chunk grid axis).
//
// What bounds it: at the forward loss path's shape (B = 8, S = 1024,
// H = 64, Dk = Dv = 64, bf16 r/k/v and o, fp32 log_w) the function moves
// 402.7 MB and needs ~11 GFLOP, ~27 flops a byte, far below the tensor
// cores' ridge of ~295: memory bounds it, 0.1202 ms at 3.35 TB/s.  Its
// 512 blocks fit the card in one wave only at 4 blocks an SM, so a block
// may hold ~56 KB of shared memory and 128 registers a thread.
//
// Two kernels:
//
// * tc::rwkv6_fwd<DK, DV>, bf16 (the loss path).  Tokens go in sub-chunks
//   of 16, two to a ring stage of 32, whatever chunk the caller names (the
//   chunked form is exact for any chunk; the result is the same function).
//   Within a sub-chunk, with w = 2^(log_w log2 e) (one ex2.approx.ftz a
//   (token, channel): 2,048 MUFU ops a stage of 32 tokens at Dk = 64,
//   against the first kernel's 31,744 accurate expf a chunk of 32):
//     R_i = r_i prod_{t<i} w_t     K_j = k_j prod_{t>j} w_t
//     D   = prod_t w_t             A_ij = sum_c r_ic k_jc prod_{j<t<i} w_tc
//     o_i = R_i S + sum_{j<i} A_ij v_j + (r_i . u . k_i) v_i
//     S   = diag(D) S + sum_j K_j^T v_j
//   Every decay is a running product of factors w <= 1: no factor ever
//   exceeds 1 and none is formed for a pair j >= i, so what underflows to
//   0 is what the exact value rounds to (the reference's guarantee,
//   kernel.py:14-15, without its exp(L_i - L_j) differences).  The next
//   sub-chunk starts from the new S, so the pairs across two sub-chunks
//   go through S and need no scores of their own.  Within a sub-chunk the
//   pairs across its two groups of 8 tokens factor at the boundary:
//   A_ij = M_i . M_j with M_i = r_i prod_{8<=t<i} w_t and M_j = k_j
//   prod_{j<t<8} w_t, both <= 1 in every factor; only the 2 x 36 pairs
//   (and bonuses) within a group keep the per-channel form.  Per stage:
//   - staging: warp w takes sub-chunk w / (Dk/32) and 32 of its channels,
//     a lane the group lane / 16 and two channels.  It reads its 8 tokens
//     of r, k (bf16x2) and log_w (float2), forms w, R, K, M and D by
//     prefix and suffix products in registers (the other group's product
//     by one shuffle) and writes R, K and M to shared memory as bf16 hi +
//     lo parts (hi = bf16(x), lo = bf16(x - hi)), two channels a 32-bit
//     store.  Then the group's 36 values, r_i k_j prod w per channel (the
//     running product of column j kept in a register) and r_i u k_i,
//     summed over the lane's two channels and reduce-scattered over the
//     16 lanes of its half-warp, pieces of 8 (4 + 2 + 1 + 1 shuffles);
//     and the 8 x 8 cross block of its 32 channels as 6 mma.sync from M.
//     Each warp writes its partial sums to its own slot, summed by the
//     products' readers: shared-memory fp32 atomics made a first version
//     markedly slower;
//   - products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//     accumulate), transposed so that S never leaves the registers: warp
//     w keeps rows 16w..16w+15 of S^T (dv x Dk, 32 fp32 a thread at Dk =
//     64) in the accumulators of the state update, which are the A
//     fragments of o^T = S^T R^T.  o^T += V^T A^T (A from the stage
//     warps' partial sums) and S^T = S^T diag(D) + V^T K share one V^T
//     fragment (ldmatrix.trans); o leaves through a per-warp tile in
//     16-byte stores;
//   - rounding: v is exact in bf16.  S, R, K, A and M are not, and one
//     bf16 part of any of them moves o by more than the reference's 5e-2
//     where S grows over hundreds of tokens (the model's slow decays), so
//     each goes in as hi + lo parts: S R^T and M M^T take 3 products (hi
//     hi, hi lo, lo hi), V^T A^T and V^T K 2 each, ~16 bits of each
//     operand (tests/test_torch_rwkv6_scan.py models the design and reads
//     each choice);
//   - a TMA ring: one thread issues the next stage's loads (4-D tensor
//     maps over [B, S, H, D], boxes of 32 tokens; r, k, log_w into one
//     slot, v into two, 128-byte swizzled for ldmatrix) on one mbarrier,
//     and they land under this stage's products; two __syncthreads a
//     stage of 32 tokens (the first kernel has six a chunk of 32).  With
//     cp.async, 16 bytes a thread, every warp stalled issuing its share
//     of the loads before it could start its products.  R, K and M, read
//     by ldmatrix and written by lanes 8 rows apart at once, are
//     XOR-swizzled by 16-byte unit so that neither conflicts on banks.
//   One block of 2 max(Dk, Dv) threads; 54 KB of shared memory at Dk =
//   Dv = 64, so four blocks share an SM and the 512 blocks of the loss
//   path run in one wave.  The tensor maps are built on the host at each
//   launch and passed by value (__grid_constant__), so a captured CUDA
//   graph replays them.  Supported: Dk, Dv in {32, 64, 128}, S a
//   multiple of 16, r, k, v and log_w 16-byte aligned.
//
// * simt::rwkv6_fwd<T, DK, DV, C>, the first kernel (fp32 products on the
//   CUDA cores from shared memory, one 256-thread block per (batch, head),
//   the chunk staged as fp32, one expf per (i, j, channel) of the intra
//   term).  It serves fp32 inputs; its bf16 instantiation is on no path,
//   a yardstick that chip_smoke.py times beside the tensor-core kernel.
//   Chunked as the TPU kernel does it: with L the inclusive cumulative
//   log-decay within a chunk of C tokens,
//     o_i = (r_i * exp(L_{i-1})) S + sum_{j<i} (sum_c r_ic k_jc
//           exp(L_{i-1,c} - L_jc)) v_j + (r_i . u . k_i) v_i
//     S'  = diag(exp(L_{C-1})) S + sum_j (k_j * exp(L_{C-1} - L_j))^T v_j
//   every exponent <= 0, the intra exponent clamped at 0 as in the
//   reference.  Each chunk is staged as fp32 in shared memory, rows of r,
//   k and L padded by one float; then, one barrier apart: L by a
//   sequential sum per channel; the intra scores and bonuses (one work
//   item a thread, triangular index); r and k scaled by their decays; o,
//   then S, each a register tile of rows by 4 columns a thread.  The chunk
//   is a template parameter (54 instantiations: 2 dtypes x 3 Dk x 3 Dv x
//   3 chunks); a chunk of 32 at Dk = Dv = 64 takes 53 KB of shared memory.
//   Supported: Dk, Dv in {32, 64, 128}, chunk in {16, 32, 64} dividing S.
//   Rounding: fp32 throughout with explicit fmaf and expf (the build
//   passes --fmad=false).
//
// Both sum in another order than the plain version
// (kernels/rwkv6_scan/ref.py, token by token), so they agree with it
// within the reference's kernel tolerances (fp32 2e-3, bf16 5e-2, rtol
// 1e-2), not bit for bit.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <limits.h>
#include <stddef.h>

namespace {

// ---------------------------------------------------------------------------
// simt: fp32 products on the CUDA cores (fp32 inputs; bf16 only as a
// yardstick)
// ---------------------------------------------------------------------------
namespace simt {


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


}  // namespace simt

// ---------------------------------------------------------------------------
// tc: bf16 on the tensor cores (the loss path)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kSub = 16;                       // tokens a sub-chunk
constexpr int kStage = 2 * kSub;               // tokens a ring stage
constexpr int kGrp = kSub / 2;                 // tokens a group
// a stage warp's partial sums of A: each group's 36 values (i, j <= i,
// in row order), then the 8 x 8 cross block at kCross
constexpr int kGrpSlot = kGrp * (kGrp + 1) / 2;
constexpr int kCross = 2 * kGrpSlot;
constexpr int kPart = kCross + kGrp * kGrp;
constexpr float kLog2e = 1.4426950408889634f;

// Threads, and byte offsets of the block's dynamic shared memory.
template <int DK, int DV>
struct Cfg {
  static constexpr int kThreads = 2 * (DK > DV ? DK : DV);
  static constexpr int kMinBlocks = 512 / kThreads;   // 128 registers
  static constexpr int kMmaWarps = DV / 16;
  static constexpr int kTileK = kStage * DK * 2;      // a bf16 [32][DK] tile
  static constexpr int kV = 0;                        // v [2][32][DV]:
  static constexpr int kVB = DV < 64 ? DV : 64;       // column blocks of
  static constexpr int kVSlot = kStage * DV * 2;      // kVB, TMA-swizzled
  static constexpr int kLw = kV + 2 * kVSlot;         // log_w [32][DK] fp32
  static constexpr int kR = kLw + 2 * kTileK;         // r, as loaded
  static constexpr int kK = kR + kTileK;              // k, as loaded
  static constexpr int kRh = kK + kTileK;             // R hi, swizzled
  static constexpr int kRl = kRh + kTileK;            // R lo
  static constexpr int kKh = kRl + kTileK;            // K hi
  static constexpr int kKl = kKh + kTileK;            // K lo
  static constexpr int kMh = kKl + kTileK;            // M hi, swizzled
  static constexpr int kMl = kMh + kTileK;            // M lo
  static constexpr int kStageWarps = DK / 16;         // 2 per 32 channels
  static constexpr int kA = kMl + kTileK;   // partial sums of A, fp32
                                            // [stage warp][kPart]
  static constexpr int kD = kA + kStageWarps * kPart * 4;
  static constexpr int kO = kD + 2 * DK * 4;          // o [warp][16][16]
  static constexpr int kBar = kO + kMmaWarps * kSub * 16 * 2;   // mbarrier
  // + 1 KB to align the base to the 128-byte swizzle's 1 KB atoms
  static constexpr int kBytes = kBar + 16 + 1024;
  static_assert(kRh % 16 == 0 && kD % 16 == 0 && kO % 16 == 0,
                "16-byte aligned tiles");
};

// Where 16-byte unit c of row t of a bf16 tile with NCH units a row is
// stored: ldmatrix reads one unit of 8 consecutive rows, which then fall
// in 8 different bank groups.
template <int NCH>
__device__ __forceinline__ int swz(int t, int c) {
  static_assert(NCH == 4 || NCH % 8 == 0, "rows of 64 or k*128 bytes");
  // rows 8 apart (which the staging lanes write at once) also differ
  return NCH == 4 ? c ^ ((t >> 1) & 3) : c ^ (t & 7) ^ ((t >> 1) & 4);
}

// Where the TMA's 128-byte (64-byte) swizzle puts 16-byte unit c of row t
// of a box with 128-byte (64-byte) rows: ldmatrix's 8 rows at one unit
// fall in 8 different bank groups.
template <int NCH>
__device__ __forceinline__ int tma_swz(int t, int c) {
  return NCH == 8 ? c ^ (t & 7) : c ^ ((t >> 1) & 3);
}

// Byte offset of element (t, c) of a v slot: column blocks of kVB.
template <int DV>
__device__ __forceinline__ int v_at(int t, int c) {
  constexpr int VB = DV < 64 ? DV : 64;
  return (c / VB) * 32 * VB * 2 + t * VB * 2 +
         tma_swz<VB / 8>(t, (c % VB) >> 3) * 16 + (c & 7) * 2;
}

// Byte offset of element (t, c) of a swizzled bf16 tile of rows of N.
template <int N>
__device__ __forceinline__ int at(int t, int c) {
  return t * N * 2 + swz<N / 8>(t, c >> 3) * 16 + (c & 7) * 2;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The box of a 4-D map over [B, S, H, D] at (b, t, h, d) into shared
// memory; rows past S arrive as zeros.
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         unsigned bar, int d, int h, int t,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(d), "r"(h), "r"(t),
      "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&d)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&d)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr)
      : "memory");
}

// c += a b, one m16n8k16 tile: bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// (x0, x1) as bf16x2 hi and lo parts, x0 in the low half: hi + lo holds
// ~16 bits of each.
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// (x0, x1) as bf16x2 hi and lo parts at byte offset off of two tiles.
__device__ __forceinline__ void put_split2(unsigned char* hi,
                                           unsigned char* lo, int off,
                                           float x0, float x1) {
  unsigned h, l;
  split2(x0, x1, h, l);
  *reinterpret_cast<unsigned*>(hi + off) = h;
  *reinterpret_cast<unsigned*>(lo + off) = l;
}

__device__ __forceinline__ float2 unpack2(unsigned x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// Sums over the 16 lanes of each half-warp, reduce-scatter: each round
// keeps half the values and adds the partner lane's copy of them.
// 8 values: the lane gets the sum of v[(lane % 16) / 2] (4 + 2 + 1 + 1
// shuffles).
__device__ __forceinline__ float reduce16_8(float (&v)[8], int lane) {
  const bool b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float a[4], c[2];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float send = b3 ? v[m] : v[m + 4];
    a[m] = (b3 ? v[m + 4] : v[m]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float send = b2 ? a[m] : a[m + 2];
    c[m] = (b2 ? a[m + 2] : a[m]) + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  const float send = b1 ? c[0] : c[1];
  const float x = (b1 ? c[1] : c[0]) + __shfl_xor_sync(0xffffffffu, send, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

// 4 values: the lane gets the sum of v[(lane % 16) / 4].
__device__ __forceinline__ float reduce16_4(float (&v)[4], int lane) {
  const bool b3 = lane & 8, b2 = lane & 4;
  float a[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float send = b3 ? v[m] : v[m + 2];
    a[m] = (b3 ? v[m + 2] : v[m]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = b2 ? a[0] : a[1];
  float x = (b2 ? a[1] : a[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

template <int DK, int DV>
__global__ void __launch_bounds__(Cfg<DK, DV>::kThreads,
                                  Cfg<DK, DV>::kMinBlocks)
    rwkv6_fwd(const __grid_constant__ CUtensorMap tm_r,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_lw,
              const __grid_constant__ CUtensorMap tm_v,
              const float* __restrict__ u, __nv_bfloat16* __restrict__ o,
              int S, int H) {
  using C = Cfg<DK, DV>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  // the 128-byte swizzle's atoms are 1 KB: align the base to them
  const unsigned sb = (smem_u32(tc_smem) + 1023u) & ~1023u;
  unsigned char* smem = tc_smem + (sb - smem_u32(tc_smem));
  const unsigned bar = sb + C::kBar;
  float* sA = reinterpret_cast<float*>(smem + C::kA);
  float* sD = reinterpret_cast<float*>(smem + C::kD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const size_t tok_v = size_t(H) * DV;   // elements between two tokens
  const size_t base_v = size_t(b) * S * tok_v + size_t(h) * DV;
  const int n_stages = (S + kStage - 1) / kStage;

  // staging role: warp w takes sub-chunk w / NQ and channels 32 (w % NQ)
  // .. + 31 of it; its lane takes the group of 8 tokens lane / 16 and the
  // channels c0, c0 + 1
  constexpr int NQ = DK / 32;
  const bool stager = tid < 2 * DK;
  const int ssub = warp / NQ, cq = warp % NQ;
  const int gp = lane >> 4;
  const int c0 = 32 * cq + 2 * (lane & 15);
  const float u0 = stager ? u[size_t(h) * DK + c0] : 0.f;
  const float u1 = stager ? u[size_t(h) * DK + c0 + 1] : 0.f;

  // Stage n's r, k, log_w into their one slot and v into slot n % 2, by
  // TMA from one thread, on one mbarrier (one phase a stage)
  auto load = [&](int n) {
    if (tid != 0) return;
    // r and k (bf16), log_w (fp32), v
    mbar_expect_tx(bar, 2 * C::kTileK + 2 * C::kTileK + C::kVSlot);
    const int t0 = n * kStage;
    tma_load(sb + C::kR, &tm_r, bar, 0, h, t0, b);
    tma_load(sb + C::kK, &tm_k, bar, 0, h, t0, b);
    tma_load(sb + C::kLw, &tm_lw, bar, 0, h, t0, b);
#pragma unroll
    for (int cb = 0; cb < DV / C::kVB; ++cb)
      tma_load(sb + C::kV + (n & 1) * C::kVSlot + cb * kStage * C::kVB * 2,
               &tm_v, bar, cb * C::kVB, h, t0, b);
  };

  // this warp's 16 rows (dv) of S^T by DK columns (channels): n-tile nt
  // holds (dv g, ch 8nt + 2q + {0, 1}) and (dv g + 8, the same)
  float s[DK / 8][4];
#pragma unroll
  for (int nt = 0; nt < DK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load(0);
  for (int n = 0; n < n_stages; ++n) {
    mbar_wait(bar, n & 1);
    __syncthreads();   // stage n landed; stage n-1's products are done

    if (stager) {
      const int tb = kSub * ssub + kGrp * gp;   // the group's first token
      unsigned r2[kGrp], k2[kGrp];
      float w0[kGrp], w1[kGrp];
#pragma unroll
      for (int t = 0; t < kGrp; ++t) {
        const int off = ((tb + t) * DK + c0) * 2;
        r2[t] = *reinterpret_cast<const unsigned*>(smem + C::kR + off);
        k2[t] = *reinterpret_cast<const unsigned*>(smem + C::kK + off);
        const float2 l = *reinterpret_cast<const float2*>(
            smem + C::kLw + ((tb + t) * DK + c0) * 4);
        w0[t] = ex2(l.x * kLog2e);
        w1[t] = ex2(l.y * kLog2e);
      }
      // the group's decay, and the other group's (lane ^ 16)
      float g0 = 1.f, g1 = 1.f;
#pragma unroll
      for (int t = 0; t < kGrp; ++t) {
        g0 *= w0[t];
        g1 *= w1[t];
      }
      const float o0 = __shfl_xor_sync(0xffffffffu, g0, 16);
      const float o1 = __shfl_xor_sync(0xffffffffu, g1, 16);
      // R_t = r_t prod_{tau < t} w_tau from the sub-chunk's start; D
      float p0 = gp ? o0 : 1.f, p1 = gp ? o1 : 1.f;
#pragma unroll
      for (int t = 0; t < kGrp; ++t) {
        const float2 x = unpack2(r2[t]);
        put_split2(smem + C::kRh, smem + C::kRl, at<DK>(tb + t, c0),
                   x.x * p0, x.y * p1);
        p0 *= w0[t];
        p1 *= w1[t];
      }
      if (gp) {
        sD[ssub * DK + c0] = p0;
        sD[ssub * DK + c0 + 1] = p1;
      }
      // K_t = k_t prod_{tau > t} w_tau to the sub-chunk's end
      p0 = gp ? 1.f : o0;
      p1 = gp ? 1.f : o1;
#pragma unroll
      for (int t = kGrp - 1; t >= 0; --t) {
        const float2 x = unpack2(k2[t]);
        put_split2(smem + C::kKh, smem + C::kKl, at<DK>(tb + t, c0),
                   x.x * p0, x.y * p1);
        p0 *= w0[t];
        p1 *= w1[t];
      }
      // M, the factors of the pairs across the two groups (i in 8..15, j
      // in 0..7): r_i prod_{8<=t<i} w_t (group 1, t upwards) and k_j
      // prod_{j<t<8} w_t (group 0, t downwards), without a branch
      p0 = 1.f;
      p1 = 1.f;
#pragma unroll
      for (int m = 0; m < kGrp; ++m) {
        const int t = gp ? m : kGrp - 1 - m;
        const float2 x = unpack2(gp ? r2[m] : k2[kGrp - 1 - m]);
        put_split2(smem + C::kMh, smem + C::kMl, at<DK>(tb + t, c0),
                   x.x * p0, x.y * p1);
        p0 *= gp ? w0[m] : w0[kGrp - 1 - m];
        p1 *= gp ? w1[m] : w1[kGrp - 1 - m];
      }
      float* part = sA + warp * kPart;
      // this lane's two channels' values of the pairs within its group,
      // r_i k_j prod_{j<t<i} w_t (x carries k_j times the product so far),
      // and bonuses r_i u k_i, summed over the warp's 32 channels 8
      // values at a time (36 a group: four pieces of 8, then 4)
      {
        float x0[kGrp], x1[kGrp], vals[8];
#pragma unroll
        for (int ii = 0; ii < kGrp; ++ii) {
          if (ii > 0) {
#pragma unroll
            for (int jj = 0; jj + 1 < ii; ++jj) {
              x0[jj] *= w0[ii - 1];
              x1[jj] *= w1[ii - 1];
            }
            const float2 kj = unpack2(k2[ii - 1]);
            x0[ii - 1] = kj.x;
            x1[ii - 1] = kj.y;
          }
          const float2 ri = unpack2(r2[ii]);
#pragma unroll
          for (int jj = 0; jj <= ii; ++jj) {
            const int p = ii * (ii + 1) / 2 + jj;
            if (jj < ii) {
              vals[p % 8] = ri.x * x0[jj] + ri.y * x1[jj];
            } else {
              const float2 ki = unpack2(k2[ii]);
              vals[p % 8] = ri.x * u0 * ki.x + ri.y * u1 * ki.y;
            }
            if (p % 8 == 7) {
              const float sum = reduce16_8(vals, lane);
              if ((lane & 1) == 0)
                part[kGrpSlot * gp + 8 * (p / 8) + ((lane & 15) >> 1)] =
                    sum;
            }
          }
        }
        float tail[4] = {vals[0], vals[1], vals[2], vals[3]};
        const float sum = reduce16_4(tail, lane);
        if ((lane & 3) == 0)
          part[kGrpSlot * gp + 32 + ((lane & 15) >> 2)] = sum;
      }
      // the cross pairs of the warp's 32 channels on the tensor cores:
      // rows i (8..15, twice over), n-tile j (0..7), M hi + lo parts
      __syncwarp();
      {
        const int rb = kSub * ssub;
        float cx[3][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f},
                          {0.f, 0.f, 0.f, 0.f}};
        const int l8 = lane & 7, m4 = lane >> 3;
        const int offb = at<DK>(rb + l8, 32 * cq + 8 * m4);
        unsigned bh[4], bl[4];
        ldsm_x4(bh, sb + C::kMh + offb);
        ldsm_x4(bl, sb + C::kMl + offb);
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          const int offa = at<DK>(rb + kGrp + l8,
                                  32 * cq + 16 * kc + 8 * (m4 >> 1));
          unsigned ah[4], al[4];
          ldsm_x4(ah, sb + C::kMh + offa);
          ldsm_x4(al, sb + C::kMl + offa);
          mma(cx[0], ah, bh[2 * kc], bh[2 * kc + 1]);
          mma(cx[1], ah, bl[2 * kc], bl[2 * kc + 1]);
          mma(cx[2], al, bh[2 * kc], bh[2 * kc + 1]);
        }
        const int g = lane >> 2, q = lane & 3;
        *reinterpret_cast<float2*>(part + kCross + 8 * g + 2 * q) =
            make_float2(cx[0][0] + cx[1][0] + cx[2][0],
                        cx[0][1] + cx[1][1] + cx[2][1]);
      }
    }
    __syncthreads();   // R, K, D and A of stage n are complete
    // the slot of r, k, log_w is read; v's slot (n + 1) % 2 was last read
    // by stage n-1's products
    if (n + 1 < n_stages) load(n + 1);

    if (warp < C::kMmaWarps) {
      const int g = lane >> 2, q = lane & 3;   // mma fragment coordinates
      const int l8 = lane & 7, m4 = lane >> 3;  // ldmatrix row, matrix
      const unsigned vb = sb + C::kV + (n & 1) * C::kVSlot;
      __nv_bfloat16* os =
          reinterpret_cast<__nv_bfloat16*>(smem + C::kO) + warp * kSub * 16;
#pragma unroll
      for (int sub = 0; sub < 2; ++sub) {
        const int t0 = n * kStage + sub * kSub;
        if (t0 >= S) break;
        const int rb = sub * kSub;   // first row of the sub-chunk in a tile
        // o^T = S^T R^T (m = dv, n = token, k = channel)
        // three partial sums (hi hi, hi lo, lo hi), so that no chain of
        // dependent mma.sync is longer than DK / 16 + 1
        float oc[3][2][4];
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) oc[p][nt][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < DK / 16; ++kc) {
          unsigned ah[4], al[4], bh[4], bl[4];
          split2(s[2 * kc][0], s[2 * kc][1], ah[0], al[0]);
          split2(s[2 * kc][2], s[2 * kc][3], ah[1], al[1]);
          split2(s[2 * kc + 1][0], s[2 * kc + 1][1], ah[2], al[2]);
          split2(s[2 * kc + 1][2], s[2 * kc + 1][3], ah[3], al[3]);
          const int off =
              at<DK>(rb + 8 * (m4 >> 1) + l8, 8 * (2 * kc + (m4 & 1)));
          ldsm_x4(bh, sb + C::kRh + off);
          ldsm_x4(bl, sb + C::kRl + off);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            mma(oc[0][nt], ah, bh[2 * nt], bh[2 * nt + 1]);
            mma(oc[1][nt], ah, bl[2 * nt], bl[2 * nt + 1]);
            mma(oc[2][nt], al, bh[2 * nt], bh[2 * nt + 1]);
          }
        }
        // V^T of the sub-chunk (m = dv, k = token), for both products below
        unsigned va[4];
        ldsm_x4_t(va, vb + v_at<DV>(rb + 8 * (m4 >> 1) + l8,
                                    8 * (2 * warp + (m4 & 1))));
        // o^T += V^T A^T (n = token i, k = token j): for i in 0..7 only j
        // in 0..7 (A is 0 above i = j); for i in 8..15, j in 0..7 is the
        // cross block and j in 8..15 the second group
        {
          // A at (g, 2q + e) and (8 + g, 8 + 2q + e): value 2q + e of row g
          // of either group, 0 above the diagonal; and the cross pairs (8 +
          // g, 2q + e); each summed over the sub-chunk's stage warps
          float2 a00 = make_float2(0.f, 0.f), a11 = a00, cr = a00;
          const int p0 = g * (g + 1) / 2 + 2 * q;
#pragma unroll
          for (int w = 0; w < NQ; ++w) {
            const float* pw = sA + (sub * NQ + w) * kPart;
            if (2 * q <= g) {
              a00.x += pw[p0];
              a11.x += pw[kGrpSlot + p0];
            }
            if (2 * q + 1 <= g) {
              a00.y += pw[p0 + 1];
              a11.y += pw[kGrpSlot + p0 + 1];
            }
            const float2 c = *reinterpret_cast<const float2*>(
                pw + kCross + 8 * g + 2 * q);
            cr.x += c.x;
            cr.y += c.y;
          }
          unsigned h0, l0, h1, l1;
          split2(a00.x, a00.y, h0, l0);
          mma(oc[0][0], va, h0, 0u);
          mma(oc[1][0], va, l0, 0u);
          split2(cr.x, cr.y, h0, l0);
          split2(a11.x, a11.y, h1, l1);
          mma(oc[0][1], va, h0, h1);
          mma(oc[1][1], va, l0, l1);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            oc[0][nt][e] += oc[1][nt][e] + oc[2][nt][e];
        // o out: the warp's 16 dv of 16 tokens through its tile, then one
        // 16-byte store a lane
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int t = 8 * nt + 2 * q;
          os[t * 16 + g] = __float2bfloat16_rn(oc[0][nt][0]);
          os[(t + 1) * 16 + g] = __float2bfloat16_rn(oc[0][nt][1]);
          os[t * 16 + g + 8] = __float2bfloat16_rn(oc[0][nt][2]);
          os[(t + 1) * 16 + g + 8] = __float2bfloat16_rn(oc[0][nt][3]);
        }
        __syncwarp();
        {
          const int t = lane >> 1, hf = lane & 1;
          *reinterpret_cast<uint4*>(o + base_v + size_t(t0 + t) * tok_v +
                                    16 * warp + 8 * hf) =
              *reinterpret_cast<const uint4*>(os + t * 16 + 8 * hf);
        }
        __syncwarp();
        // S^T = S^T diag(D) + V^T K (n = channel, k = token)
#pragma unroll
        for (int nt = 0; nt < DK / 8; ++nt) {
          const float2 d =
              *reinterpret_cast<const float2*>(sD + sub * DK + 8 * nt + 2 * q);
          s[nt][0] *= d.x;
          s[nt][1] *= d.y;
          s[nt][2] *= d.x;
          s[nt][3] *= d.y;
        }
#pragma unroll
        for (int np = 0; np < DK / 16; ++np) {
          const int off =
              at<DK>(rb + 8 * (m4 & 1) + l8, 8 * (2 * np + (m4 >> 1)));
          unsigned kh[4], kl[4];
          ldsm_x4_t(kh, sb + C::kKh + off);
          ldsm_x4_t(kl, sb + C::kKl + off);
          mma(s[2 * np], va, kh[0], kh[1]);
          mma(s[2 * np], va, kl[0], kl[1]);
          mma(s[2 * np + 1], va, kh[2], kh[3]);
          mma(s[2 * np + 1], va, kl[2], kl[3]);
        }
      }
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

// A 4-D map over a contiguous [B, S, H, D] tensor (innermost first) of
// elements of `bytes` bytes, boxes of `cols` columns x 1 head x `rows`
// positions, zero fill past the edges.
bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
              int bytes, int B, int S, int H, int D, int cols, int rows,
              CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * bytes,
                                 cuuint64_t(H) * D * bytes,
                                 cuuint64_t(S) * H * D * bytes};
  const cuuint32_t box[4] = {cuuint32_t(cols), 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DK, int DV>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const float* u, void* o, int B, int S, int H,
           cudaStream_t stream) {
  using C = Cfg<DK, DV>;
  constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tm_r, tm_k, tm_lw, tm_v;
  if (!make_map(&tm_r, r, kBf16, 2, B, S, H, DK, DK, kStage,
                CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&tm_k, k, kBf16, 2, B, S, H, DK, DK, kStage,
                CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&tm_lw, lw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B, S, H, DK,
                DK, kStage, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&tm_v, v, kBf16, 2, B, S, H, DV, C::kVB, kStage,
                C::kVB == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_fwd<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kBytes);
  if (err != cudaSuccess) return int(err);
  // as much of the SM's memory as shared as it offers: four blocks of the
  // loss path's shape share one SM
  err = cudaFuncSetAttribute(rwkv6_fwd<DK, DV>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (long long)B * H;
  if (blocks > INT_MAX) return int(cudaErrorInvalidConfiguration);
  rwkv6_fwd<DK, DV><<<unsigned(blocks), C::kThreads, C::kBytes, stream>>>(
      tm_r, tm_k, tm_lw, tm_v, u, static_cast<__nv_bfloat16*>(o), S, H);
  return int(cudaGetLastError());
}

template <int DK>
int launch_dv(const void* r, const void* k, const void* v, const float* lw,
              const float* u, void* o, int B, int S, int H, int Dv,
              cudaStream_t s) {
  switch (Dv) {
    case 32:
      return launch<DK, 32>(r, k, v, lw, u, o, B, S, H, s);
    case 64:
      return launch<DK, 64>(r, k, v, lw, u, o, B, S, H, s);
    case 128:
      return launch<DK, 128>(r, k, v, lw, u, o, B, S, H, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

int launch_dk(const void* r, const void* k, const void* v, const float* lw,
              const float* u, void* o, int B, int S, int H, int Dk, int Dv,
              cudaStream_t s) {
  if (S % kSub) return int(cudaErrorInvalidValue);
  switch (Dk) {
    case 32:
      return launch_dv<32>(r, k, v, lw, u, o, B, S, H, Dv, s);
    case 64:
      return launch_dv<64>(r, k, v, lw, u, o, B, S, H, Dv, s);
    case 128:
      return launch_dv<128>(r, k, v, lw, u, o, B, S, H, Dv, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// r, k, log_w: [B, S, H, Dk]; v, o: [B, S, H, Dv]; u: [H, Dk]; contiguous.
// r, k, v, o in one dtype (0 = fp32, 1 = bf16); log_w and u fp32.
// Dk, Dv in {32, 64, 128}; chunk in {16, 32, 64}, S a positive multiple.
// design 0: the CUDA-core kernel (either dtype); 1: the tensor-core kernel
// (bf16 only; r, k, v and log_w 16-byte aligned).
int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                      const void* log_w, const void* u, void* o, int dtype,
                      int B, int S, int H, int Dk, int Dv, int chunk,
                      void* stream, int design) {
  if (B < 1 || H < 1 || S < 1 ||
      (chunk != 16 && chunk != 32 && chunk != 64) || S % chunk)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lw = static_cast<const float*>(log_w);
  const float* uf = static_cast<const float*>(u);
  if (design == 1 && dtype == 1)
    return tc::launch_dk(r, k, v, lw, uf, o, B, S, H, Dk, Dv, s);
  if (design != 0) return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return simt::launch_dk<float>(r, k, v, lw, uf, o, B, S, H, Dk, Dv, chunk,
                                  s);
  if (dtype == 1)
    return simt::launch_dk<__nv_bfloat16>(r, k, v, lw, uf, o, B, S, H, Dk,
                                          Dv, chunk, s);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
