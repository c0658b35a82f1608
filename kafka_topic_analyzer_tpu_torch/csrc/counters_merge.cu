// Wire-v5 counter-table merge for Hopper: per_partition += delta, exact i64,
// with the step's two global sums in the same launch.
//
// Replaces the Pallas kernel `_merge_kernel` / `pallas_counters_merge`
// (kafka_topic_analyzer_tpu/ops/pallas_counters.py:216, :224).  The TPU
// kernel splits every int64 into a u32 low digit and an i32 high digit and
// adds them with an explicit carry, because TPU Pallas has no i64 lanes.
// Hopper adds int64 natively, so the digit planes and the carry are gone:
// each thread adds its cells of the [P, 7] tables in uint64, which wraps
// modulo 2^64 exactly like the TPU kernel's digit arithmetic (signed
// overflow would be undefined in C++).
//
// Optional global sums: when `overall_size` and `overall_count` are given,
// the same launch also adds the delta's key and value byte channels into
// `overall_size` and its record-count channel into `overall_count` (the JAX
// step's backends/step.py:227-228).  The kernel knows no channel by name:
// the wrapper passes each sum's channels as a bit mask over the seven,
// taken from results.COUNTER_CHANNELS.  Each thread keeps both partial sums
// in registers while it merges; the block reduces them with warp shuffles
// and shared memory, and one thread adds each into its scalar with one
// 64-bit global atomicAdd.  Everything wraps mod 2^64 like the JAX int64
// sum.  Without the scalars (the reference's two-argument signature) the
// launch is the plain add.
//
// In place: the result is written into `acc` (per_partition).  The JAX
// step is pure and donates its buffers instead; the port's state owns its
// tensors, so updating them in place saves the output allocation.
//
// Bound: the kernel reads two tables and writes one, 3 * 56 * P bytes
// (2.7 KB at P = 16, 5.5 MB at the P <= 32767 cap), plus 32 bytes for the
// two scalars; at 3.35 TB/s that is under a nanosecond at the scan's P,
// far below one launch.  What the old design lost was on the host: a launch
// measured 2.3-2.7x one `torch.add` because the wrapper's Python checks,
// the `torch.cuda.current_stream()` object and a per-argument ctypes
// conversion cost more than PyTorch's C++ dispatch, and the step then spent
// five more launches on the two sums.  This design takes its arguments as
// one packed record (one ctypes conversion), checks the current device
// here, reads the SM count once per device, and carries the sums, so the
// v5 counter fold is one launch instead of six.  A single block covers the
// scan's P = 16; larger tables spread over up to 4 blocks per SM.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; the
// Python wrapper (ops/counters_merge.py) checks the tensors and passes raw
// pointers and PyTorch's current stream.

#include "kta_launch.cuh"

// The wrapper's argument record: nine little-endian 64-bit fields, packed
// by ops/counters_merge.py with struct format "<QQqQQqqQq".  It lies outside
// the anonymous namespace so that the extern "C" entry taking it keeps
// external linkage.
struct KtaMergeArgs {
  uint64_t acc;            // int64[P, 7], updated in place
  uint64_t delta;          // int64[P, 7]
  int64_t n;               // 7 * P
  uint64_t overall_size;   // int64 scalar or 0
  uint64_t overall_count;  // int64 scalar or 0
  int64_t count_mask;      // bit c set: channel c adds into overall_count
  int64_t size_mask;       // bit c set: channel c adds into overall_size
  uint64_t stream;         // cudaStream_t
  int64_t device;          // the tables' CUDA device index
};

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 7;

// Sum of `v` over the block, valid in thread 0.  `scratch` holds one value
// per warp.
__device__ __forceinline__ unsigned long long block_sum(
    unsigned long long v, unsigned long long* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    if (lane < (int)(blockDim.x >> 5)) v = scratch[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    counters_merge_kernel(unsigned long long* __restrict__ acc,
                          const unsigned long long* __restrict__ delta,
                          long long n,
                          unsigned long long* __restrict__ overall_size,
                          unsigned long long* __restrict__ overall_count,
                          unsigned count_mask, unsigned size_mask) {
  const bool sums = overall_size != nullptr;
  unsigned long long size = 0, count = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long d = delta[i];
    acc[i] += d;
    if (sums) {
      const int c = (int)(i % kChannels);
      count += (count_mask >> c) & 1u ? d : 0ull;
      size += (size_mask >> c) & 1u ? d : 0ull;
    }
  }
  if (sums) {
    __shared__ unsigned long long scratch[2][kThreads / 32];
    size = block_sum(size, scratch[0]);
    count = block_sum(count, scratch[1]);
    if (threadIdx.x == 0) {
      if (size != 0) atomicAdd(overall_size, size);
      if (count != 0) atomicAdd(overall_count, count);
    }
  }
}

}  // namespace

extern "C" int kta_counters_merge(const KtaMergeArgs* a) {
  if (a->n <= 0) return 0;
  int dev = 0, sms = 0;
  int err = check_device(a->device, &dev);
  if (err == 0) err = sm_count(dev, &sms);
  if (err != 0) return err;
  long long blocks = (a->n + kThreads - 1) / kThreads;
  if (blocks > 4LL * sms) blocks = 4LL * sms;
  auto* acc = (unsigned long long*)a->acc;
  auto* delta = (const unsigned long long*)a->delta;
  counters_merge_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)a->stream>>>(
      acc, delta, a->n, (unsigned long long*)a->overall_size,
      (unsigned long long*)a->overall_count, (unsigned)a->count_mask,
      (unsigned)a->size_mask);
  return (int)cudaGetLastError();
}
