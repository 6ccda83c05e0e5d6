// A device clock stamp for the port's recorder (repro_torch/spans.py).
//
// Replaces no TPU kernel: the JAX package has no tracing.  A stamp marks a
// layer boundary of a round in stream order, so it has to be a node of the
// stream itself: inside a captured chunk a host clock sees nothing, and a
// CUDA timing event would be re-recorded by the next replay before the host
// reads it (chunk i is read only after chunk i+1 is enqueued).  The stamp
// travels with the chunk's metrics instead: one thread reads %globaltimer
// (ns) and adds it, negated for a span's start, into its slot of the
// round's int64 buffer.  Adding, mod 2^64, lets a span stamped many times a
// round (every MoE layer's forward and backward) sum its intervals.
//
// What bounds it: nothing but the launch, one thread and one 8-byte atomic.
// Stream order starts it after the kernel before it ends and the kernel
// after it once it ends, so a pair of stamps times the stream between them.
#include <cuda_runtime.h>

__global__ void stamp_kernel(unsigned long long* slot, int end) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  atomicAdd(slot, end ? t : 0ull - t);
}

extern "C" int stamp_launch(void* slot, int end, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(slot), end);
  return static_cast<int>(cudaGetLastError());
}
