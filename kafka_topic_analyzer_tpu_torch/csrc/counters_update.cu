// Wire-v4 per-partition counter update for Hopper: exact int64 segment sum.
//
// Replaces the Pallas kernel `_kernel`, reached through `_call` and
// `pallas_counters_update` (kafka_topic_analyzer_tpu/ops/pallas_counters.py:52,
// :111, :148).  For every valid record r of partition p it adds the record's
// seven counter channels (results.COUNTER_CHANNELS order: total, tombstones,
// alive, key_null, key_non_null, key bytes, value bytes) into
// per_partition[p, :].
//
// The TPU kernel is a one-hot f32 matrix product on the MXU, with byte
// lengths split into 12-bit digits so that every f32 partial stays exact,
// and an i32 VMEM accumulator carried across the sequential grid.  None of
// that is needed here: Hopper has exact 64-bit integer atomics, so the sum is
// accumulated directly in uint64 (wrapping mod 2^64, like the JAX int64
// add), exact for any int32 length and any batch size.
//
// Design (a simple one that is right):
// - Each block takes one contiguous chunk of the records; its threads stride
//   through the chunk by blockDim, so loads are coalesced.
// - Each thread keeps the running sums of the partition it is on in
//   registers and flushes them only when the partition changes (and at the
//   end), skipping zero channels.  Under a round-robin record order whose
//   partition count divides blockDim, a thread never changes partition.
// - Shared path (56·P bytes fit the block's shared memory: P <= 877 in the
//   48 KB default, P <= 4150 with the opt-in dynamic size of an H100): a
//   block-private uint64 [P, 7] histogram takes the flushes with shared
//   atomicAdd, then the block adds its nonzero cells into per_partition
//   with one global atomicAdd each.
// - Global path (larger P, up to the packer's 32767): flushes go straight to
//   per_partition with global atomicAdd.
// Records that are not valid, or whose partition lies outside [0, P), add
// nothing (the JAX scatter routes the former to a dropped row and drops
// out-of-range updates; the packer rejects the latter).
//
// Bound: the kernel must read 15 B per record (three int32 columns and three
// bool columns) and read and write the 56·P-byte table; at B = 2^18 that is
// 3.9 MB, 1.2 us at 3.35 TB/s.  It does 7·B integer adds.  Atomic contention
// on few partitions and the launch (microseconds) dominate at the scan's
// shape; chip_smoke.py measures it beside the bound.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; the
// Python wrapper (ops/counters_update.py) checks the tensors and passes raw
// pointers and PyTorch's current stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 7;
constexpr int kDefaultSharedBytes = 48 * 1024;

struct Run {
  long long p;               // partition of the run, -1 when empty
  unsigned long long c[kChannels];
};

__device__ __forceinline__ void run_reset(Run& run, long long p) {
  run.p = p;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) run.c[c] = 0;
}

__device__ __forceinline__ void run_flush(const Run& run,
                                          unsigned long long* table) {
  if (run.p < 0) return;
  unsigned long long* row = table + run.p * kChannels;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    if (run.c[c] != 0) atomicAdd(row + c, run.c[c]);
  }
}

// Folds records [lo, hi) (strided by blockDim) into `table`, which is the
// block's shared histogram or per_partition itself.
__device__ __forceinline__ void fold_chunk(
    unsigned long long* table, const int32_t* __restrict__ partition,
    const int32_t* __restrict__ key_len, const int32_t* __restrict__ value_len,
    const bool* __restrict__ key_null, const bool* __restrict__ value_null,
    const bool* __restrict__ valid, long long lo, long long hi, int num_parts) {
  Run run;
  run_reset(run, -1);
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    if (!valid[i]) continue;
    const int p = partition[i];
    if (p < 0 || p >= num_parts) continue;
    if (p != run.p) {
      run_flush(run, table);
      run_reset(run, p);
    }
    const bool kn = !key_null[i];
    const bool vn = !value_null[i];
    run.c[0] += 1ull;
    run.c[1] += vn ? 0ull : 1ull;
    run.c[2] += vn ? 1ull : 0ull;
    run.c[3] += kn ? 0ull : 1ull;
    run.c[4] += kn ? 1ull : 0ull;
    // Sign-extend like the JAX int32 -> int64 cast, then wrap in uint64.
    run.c[5] += kn ? (unsigned long long)(long long)key_len[i] : 0ull;
    run.c[6] += vn ? (unsigned long long)(long long)value_len[i] : 0ull;
  }
  run_flush(run, table);
}

__global__ void counters_update_shared_kernel(
    unsigned long long* __restrict__ per_partition,
    const int32_t* __restrict__ partition, const int32_t* __restrict__ key_len,
    const int32_t* __restrict__ value_len, const bool* __restrict__ key_null,
    const bool* __restrict__ value_null, const bool* __restrict__ valid,
    long long n, long long chunk, int num_parts) {
  extern __shared__ unsigned long long hist[];
  const int cells = num_parts * kChannels;
  for (int j = threadIdx.x; j < cells; j += blockDim.x) hist[j] = 0ull;
  __syncthreads();
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  fold_chunk(hist, partition, key_len, value_len, key_null, value_null, valid,
             lo, hi, num_parts);
  __syncthreads();
  for (int j = threadIdx.x; j < cells; j += blockDim.x) {
    const unsigned long long v = hist[j];
    if (v != 0) atomicAdd(per_partition + j, v);
  }
}

__global__ void counters_update_global_kernel(
    unsigned long long* __restrict__ per_partition,
    const int32_t* __restrict__ partition, const int32_t* __restrict__ key_len,
    const int32_t* __restrict__ value_len, const bool* __restrict__ key_null,
    const bool* __restrict__ value_null, const bool* __restrict__ valid,
    long long n, long long chunk, int num_parts) {
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  fold_chunk(per_partition, partition, key_len, value_len, key_null,
             value_null, valid, lo, hi, num_parts);
}

// Largest P whose [P, 7] uint64 histogram fits one block's shared memory on
// device `dev` (the opt-in dynamic maximum), or -1 with `err` set.
int max_shared_partitions(int dev, cudaError_t& err) {
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return -1;
  return optin / (kChannels * (int)sizeof(unsigned long long));
}

}  // namespace

extern "C" int kta_counters_update(void* per_partition, const void* partition,
                                   const void* key_len, const void* value_len,
                                   const void* key_null, const void* value_null,
                                   const void* valid, long long n,
                                   int num_parts, void* stream) {
  if (n <= 0 || num_parts <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // Two blocks per SM, each over one contiguous chunk of at least a block's
  // worth of records.
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2LL * sms) blocks = 2LL * sms;
  const long long chunk = (n + blocks - 1) / blocks;
  blocks = (n + chunk - 1) / chunk;
  const size_t shared_bytes =
      (size_t)num_parts * kChannels * sizeof(unsigned long long);
  const int max_shared_parts = max_shared_partitions(dev, err);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  auto* acc = (unsigned long long*)per_partition;
  auto* part = (const int32_t*)partition;
  auto* klen = (const int32_t*)key_len;
  auto* vlen = (const int32_t*)value_len;
  auto* knull = (const bool*)key_null;
  auto* vnull = (const bool*)value_null;
  auto* ok = (const bool*)valid;
  if (num_parts <= max_shared_parts) {
    if (shared_bytes > (size_t)kDefaultSharedBytes) {
      err = cudaFuncSetAttribute(counters_update_shared_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)shared_bytes);
      if (err != cudaSuccess) return (int)err;
    }
    counters_update_shared_kernel<<<(unsigned)blocks, kThreads, shared_bytes,
                                    s>>>(acc, part, klen, vlen, knull, vnull,
                                         ok, n, chunk, num_parts);
  } else {
    counters_update_global_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        acc, part, klen, vlen, knull, vnull, ok, n, chunk, num_parts);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kta_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
