// Wire-v5 counter-table merge for Hopper: per_partition += delta, exact i64.
//
// Replaces the Pallas kernel `_merge_kernel` / `pallas_counters_merge`
// (kafka_topic_analyzer_tpu/ops/pallas_counters.py:216, :224).  The TPU
// kernel splits every int64 into a u32 low digit and an i32 high digit and
// adds them with an explicit carry, because TPU Pallas has no i64 lanes.
// Hopper adds int64 natively, so the digit planes and the carry are gone:
// this is one grid-stride loop over the 7·P elements of the [P, 7] tables.
// The add is done in uint64 so it wraps modulo 2^64 exactly like the TPU
// kernel's digit arithmetic (signed overflow would be undefined in C++).
//
// In place: the result is written into `acc` (per_partition).  The JAX
// step is pure and donates its buffers instead; the port's state owns its
// tensors, so updating them in place saves the output allocation.
//
// Bound: the kernel reads two tables and writes one, 3 * 56 * P bytes
// (2.7 KB at P = 16, 5.5 MB at the P <= 32767 cap), which at 3.35 TB/s is
// 0.8 ns to 1.6 us — far below one launch (a few microseconds).  It is
// launch-latency-bound at every realistic P.  Fusing the whole v5 merge
// (counters, extremes, HLL, DDSketch, alive masks) into one launch is
// later work.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; the
// Python wrapper (ops/counters_merge.py) checks the tensors and passes raw
// pointers and PyTorch's current stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void counters_merge_kernel(int64_t* __restrict__ acc,
                                      const int64_t* __restrict__ delta,
                                      long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    acc[i] = (int64_t)((uint64_t)acc[i] + (uint64_t)delta[i]);
  }
}

}  // namespace

extern "C" int kta_counters_merge(void* acc, const void* delta, long long n,
                                  void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;
  counters_merge_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (int64_t*)acc, (const int64_t*)delta, n);
  return (int)cudaGetLastError();
}

extern "C" const char* kta_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
