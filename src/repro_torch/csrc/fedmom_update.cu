// Fused server update for Hopper (sm_90a): FedMom and FedAvgM over every
// leaf of the server state in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/fedmom_update/kernel.py:61
// (fused_flat; bodies _fedmom_body :39 and _fedavgm_body :49), together with
// the packing around it (_pack / _unpack, :79-97, which XLA fuses into the
// call under jit and eager PyTorch would run as separate copies).
//
//   FedMom  (kind 0):  v' = w - eta*d ;  w' = v' + beta*(v' - v)
//   FedAvgM (kind 1):  m' = beta*m + d ; w' = w - eta*m'
//
// What bounds it: 3 reads (w, state, delta) and 2 writes (w', state') per
// element, 20 bytes in float32, and 4-5 flops -- far below the card's ridge,
// so device memory is the only roofline term: 20*n bytes at 3.35 TB/s.  At
// LeNet's size (n = 40,914 in 8 leaves) that is 0.82 MB and 0.24 us, well
// under the ~1.2 us a launch costs, so on the main path the update is bound by
// latency: one launch, the time each SM needs to pull its share of the bytes
// through, and one round trip to memory.  At large n it is bound by bytes.
//
// Design, against the TPU kernel's [256, 128] VMEM tiles of one packed
// stream:
//  * no pack and no split.  The host (kernels/fedmom_update/kernel.py,
//    tree_plan) cuts the leaves into chunks of one leaf each, (leaf, offset,
//    length): a small tree into about one chunk for every two SMs (on an
//    H100 fewer, fuller blocks finished sooner than one a SM), a tree past
//    L2's size into one chunk a leaf.
//    The leaf table (five pointers, the dtypes, an alignment flag) and the
//    chunk table travel by value in one __grid_constant__ parameter block of
//    at most 4,096 bytes, so nothing is copied to the card before the launch
//    and a captured CUDA graph keeps the tables in its kernel node;
//  * block (x, y) takes chunk x and, for a chunk longer than one tile, every
//    gridDim.y-th tile of it: a small tree is one block a chunk, a large leaf
//    a bytes-bound grid-stride loop over one stream (the same leaf cut into
//    chunks that start a power of two of bytes apart streamed slower);
//  * each thread issues all its loads of a tile (one 16-byte vector of each
//    of w, state and delta; two at large n; through the read-only path)
//    before any arithmetic, then computes and stores; launches that move
//    more than about L2's size stream their stores past it (st.global.cs);
//  * leaves are read and written in their own dtype (float32, bfloat16,
//    float16) with the arithmetic in float32; a leaf whose five pointers are
//    not all 16-byte aligned takes a scalar path, chosen per chunk; a leaf
//    of float32 throughout takes a path with no dtype branch.
//
// Rounding: every operation is an explicit round-to-nearest intrinsic
// (__fmul_rn / __fadd_rn / __fsub_rn), which the compiler never contracts
// into an FMA (the build also passes --fmad=false), and a bfloat16 or
// float16 output is rounded once, to nearest even, from the float32 result.
// The plain PyTorch version (kernels/fedmom_update/ref.py, then .to() of the
// leaf's dtype) performs the same operations in the same order, so the two
// agree bit for bit.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success); a table it
// cannot take returns cudaErrorInvalidValue and launches nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFedMom = 0;
constexpr int kFedAvgM = 1;
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;
constexpr int kDtypeBits = 0x3f;     // w, state, delta: two bits each
constexpr int kAligned = 1 << 8;     // all five pointers 16-byte aligned
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 32;     // a launch's blocks: at most this a SM
constexpr long long kStreamElems = 1LL << 22;   // 80 MB moved: past L2
constexpr int kMaxLeaves = 24;
constexpr int kMaxChunks = 182;

// vectors of 4 elements a stream, a thread, a tile
template <bool STREAM>
__host__ __device__ constexpr int unroll() { return STREAM ? 2 : 1; }

struct Leaf {
  const void* w;
  const void* s;
  const void* d;
  void* w_out;
  void* s_out;
  int codes;      // dtype of w (bits 0-1), state (2-3), delta (4-5); kAligned
  int pad;
};

struct Chunk {
  long long offset;   // elements into the leaf; a multiple of 4
  int length;
  int leaf;
};

struct Params {
  Leaf leaves[kMaxLeaves];
  Chunk chunks[kMaxChunks];
  float eta;
  float beta;
};
static_assert(sizeof(Params) <= 4096,
              "the tables must fit the 4,096-byte parameter block");

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

__device__ __forceinline__ float load1(const void* p, int code, int64_t i) {
  if (code == kF32) return __ldg(static_cast<const float*>(p) + i);
  if (code == kBF16) {
    return __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(p) + i));
  }
  return __half2float(__ldg(static_cast<const __half*>(p) + i));
}

__device__ __forceinline__ void store1(void* p, int code, int64_t i,
                                       float x) {
  if (code == kF32) {
    static_cast<float*>(p)[i] = x;
  } else if (code == kBF16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  } else {
    static_cast<__half*>(p)[i] = __float2half_rn(x);
  }
}

// four neighbouring elements: one 16-byte load in float32, 8 bytes in the
// 16-bit types
__device__ __forceinline__ float4 load4(const void* p, int code, int64_t i) {
  if (code == kF32) return __ldg(static_cast<const float4*>(p) + i);
  const uint2 r = __ldg(static_cast<const uint2*>(p) + i);
  float2 lo, hi;
  if (code == kBF16) {
    lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  } else {
    lo = __half22float2(*reinterpret_cast<const __half2*>(&r.x));
    hi = __half22float2(*reinterpret_cast<const __half2*>(&r.y));
  }
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <bool STREAM>
__device__ __forceinline__ void store4(void* p, int code, int64_t i,
                                       float4 v) {
  if (code == kF32) {
    float4* q = static_cast<float4*>(p) + i;
    if (STREAM) {
      __stcs(q, v);
    } else {
      *q = v;
    }
    return;
  }
  uint2 r;
  if (code == kBF16) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    r.x = *reinterpret_cast<const unsigned*>(&lo);
    r.y = *reinterpret_cast<const unsigned*>(&hi);
  } else {
    const __half2 lo = __floats2half2_rn(v.x, v.y);
    const __half2 hi = __floats2half2_rn(v.z, v.w);
    r.x = *reinterpret_cast<const unsigned*>(&lo);
    r.y = *reinterpret_cast<const unsigned*>(&hi);
  }
  uint2* q = static_cast<uint2*>(p) + i;
  if (STREAM) {
    __stcs(q, r);
  } else {
    *q = r;
  }
}

template <int KIND>
__device__ __forceinline__ void update4(float4 w, float4 s, float4 d,
                                        float eta, float beta, float4& w_out,
                                        float4& s_out) {
  update<KIND>(w.x, s.x, d.x, eta, beta, w_out.x, s_out.x);
  update<KIND>(w.y, s.y, d.y, eta, beta, w_out.y, s_out.y);
  update<KIND>(w.z, s.z, d.z, eta, beta, w_out.z, s_out.z);
  update<KIND>(w.w, s.w, d.w, eta, beta, w_out.w, s_out.w);
}

// A chunk of a leaf whose pointers are 16-byte aligned, in vectors of 4
// elements (the chunk's offset is a multiple of 4); F32: every dtype is
// float32, so the dtype branches fold away.
template <int KIND, bool STREAM, bool F32>
__device__ __forceinline__ void vector_chunk(const Leaf& L, int64_t offset,
                                             int length, float eta,
                                             float beta) {
  const int wc = F32 ? kF32 : (L.codes & 3);
  const int sc = F32 ? kF32 : ((L.codes >> 2) & 3);
  const int dc = F32 ? kF32 : ((L.codes >> 4) & 3);
  constexpr int U = unroll<STREAM>();
  constexpr int kTileVecs = kThreads * U;
  const int64_t nvec = length >> 2;
  const int64_t v0 = offset >> 2;
  const int tid = threadIdx.x;
  // the leaf's ragged end, at most 3 elements past the last whole vector:
  // loaded with the first tile, so that its round trip to memory is theirs
  const bool tail = blockIdx.y == 0 && tid < (length & 3);
  const int64_t t = offset + nvec * 4 + tid;
  float tw = 0.f, ts = 0.f, td = 0.f;
  if (tail) {
    tw = load1(L.w, wc, t);
    ts = load1(L.s, sc, t);
    td = load1(L.d, dc, t);
  }
  for (int64_t base = (int64_t)blockIdx.y * kTileVecs; base < nvec;
       base += (int64_t)gridDim.y * kTileVecs) {
    float4 a[U], b[U], c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = base + u * kThreads + tid;
      if (i < nvec) {
        a[u] = load4(L.w, wc, v0 + i);
        b[u] = load4(L.s, sc, v0 + i);
        c[u] = load4(L.d, dc, v0 + i);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = base + u * kThreads + tid;
      if (i < nvec) {
        float4 x, y;
        update4<KIND>(a[u], b[u], c[u], eta, beta, x, y);
        store4<STREAM>(L.w_out, wc, v0 + i, x);
        store4<STREAM>(L.s_out, sc, v0 + i, y);
      }
    }
  }
  if (tail) {
    float x, y;
    update<KIND>(tw, ts, td, eta, beta, x, y);
    store1(L.w_out, wc, t, x);
    store1(L.s_out, sc, t, y);
  }
}

// A chunk of a leaf with a pointer off a 16-byte boundary: one element at
// a time, each thread's elements of a tile all loaded before any arithmetic.
template <int KIND, bool STREAM>
__device__ __forceinline__ void scalar_chunk(const Leaf& L, int64_t offset,
                                             int length, float eta,
                                             float beta) {
  constexpr int kPer = unroll<STREAM>() * 4;
  const int wc = L.codes & 3;
  const int sc = (L.codes >> 2) & 3;
  const int dc = (L.codes >> 4) & 3;
  const int tid = threadIdx.x;
  for (int64_t base = (int64_t)blockIdx.y * kThreads * kPer; base < length;
       base += (int64_t)gridDim.y * kThreads * kPer) {
    float a[kPer], b[kPer], c[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t i = base + j * kThreads + tid;
      if (i < length) {
        a[j] = load1(L.w, wc, offset + i);
        b[j] = load1(L.s, sc, offset + i);
        c[j] = load1(L.d, dc, offset + i);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t i = base + j * kThreads + tid;
      if (i < length) {
        float x, y;
        update<KIND>(a[j], b[j], c[j], eta, beta, x, y);
        store1(L.w_out, wc, offset + i, x);
        store1(L.s_out, sc, offset + i, y);
      }
    }
  }
}

template <int KIND, bool STREAM>
__global__ void __launch_bounds__(kThreads)
tree_update_kernel(const __grid_constant__ Params p) {
  const Chunk& chunk = p.chunks[blockIdx.x];
  const Leaf& leaf = p.leaves[chunk.leaf];
  if (!(leaf.codes & kAligned)) {
    scalar_chunk<KIND, STREAM>(leaf, chunk.offset, chunk.length, p.eta,
                               p.beta);
  } else if ((leaf.codes & kDtypeBits) == 0) {
    vector_chunk<KIND, STREAM, true>(leaf, chunk.offset, chunk.length, p.eta,
                                     p.beta);
  } else {
    vector_chunk<KIND, STREAM, false>(leaf, chunk.offset, chunk.length,
                                      p.eta, p.beta);
  }
}

template <int KIND>
void launch(const Params& p, dim3 grid, bool stream_stores,
            cudaStream_t stream) {
  if (stream_stores) {
    tree_update_kernel<KIND, true><<<grid, kThreads, 0, stream>>>(p);
  } else {
    tree_update_kernel<KIND, false><<<grid, kThreads, 0, stream>>>(p);
  }
}

bool valid_code(long long c) { return (c & 3) <= kF16; }

}  // namespace

// The capacity of one launch's tables and the size past which a launch
// streams; the host plan reads them to check its own copy of the numbers.
extern "C" void fedmom_update_limits(int* max_leaves, int* max_chunks,
                                     long long* stream_elems) {
  *max_leaves = kMaxLeaves;
  *max_chunks = kMaxChunks;
  *stream_elems = kStreamElems;
}

// One launch over one table.  leaves: n_leaves rows of 6 int64 (w, state,
// delta, w_out, state_out pointers; codes as Leaf::codes); chunks: n_chunks
// rows of 3 int64 (leaf row, offset, length).  Both are host memory, read
// before this returns.  sm_count sizes the grid of a long chunk.
extern "C" int fedmom_update_tree_launch(const long long* leaves,
                                         int n_leaves,
                                         const long long* chunks,
                                         int n_chunks, int kind, float eta,
                                         float beta, int sm_count,
                                         void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_chunks < 1 ||
      n_chunks > kMaxChunks || sm_count < 1 ||
      (kind != kFedMom && kind != kFedAvgM)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{};
  for (int i = 0; i < n_leaves; ++i) {
    const long long* row = leaves + 6 * i;
    const long long codes = row[5];
    if (!valid_code(codes) || !valid_code(codes >> 2) ||
        !valid_code(codes >> 4) || (codes & ~(kDtypeBits | kAligned)) != 0) {
      return (int)cudaErrorInvalidValue;
    }
    p.leaves[i].w = reinterpret_cast<const void*>(row[0]);
    p.leaves[i].s = reinterpret_cast<const void*>(row[1]);
    p.leaves[i].d = reinterpret_cast<const void*>(row[2]);
    p.leaves[i].w_out = reinterpret_cast<void*>(row[3]);
    p.leaves[i].s_out = reinterpret_cast<void*>(row[4]);
    p.leaves[i].codes = (int)codes;
  }
  long long total = 0, longest = 0;
  for (int i = 0; i < n_chunks; ++i) {
    const long long* row = chunks + 3 * i;
    const long long leaf = row[0], offset = row[1], length = row[2];
    if (leaf < 0 || leaf >= n_leaves || offset < 0 || (offset & 3) != 0 ||
        length < 1 || length > 0x7fffffffLL) {
      return (int)cudaErrorInvalidValue;
    }
    p.chunks[i].leaf = (int)leaf;
    p.chunks[i].offset = offset;
    p.chunks[i].length = (int)length;
    total += length;
    if (length > longest) longest = length;
  }
  p.eta = eta;
  p.beta = beta;
  // a long chunk is shared by gridDim.y blocks, up to kBlocksPerSm a SM
  const bool stream_stores = total > kStreamElems;
  const long long tile = 4LL * kThreads *
                         (stream_stores ? unroll<true>() : unroll<false>());
  const long long tiles = (longest + tile - 1) / tile;
  long long split = (long long)sm_count * kBlocksPerSm / n_chunks;
  if (split < 1) split = 1;
  if (split > tiles) split = tiles;
  if (split > 65535) split = 65535;
  const dim3 grid((unsigned)n_chunks, (unsigned)split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == kFedMom) {
    launch<kFedMom>(p, grid, stream_stores, st);
  } else {
    launch<kFedAvgM>(p, grid, stream_stores, st);
  }
  return (int)cudaGetLastError();
}
