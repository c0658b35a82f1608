// Wire-v4 per-partition counter update for Hopper: exact int64 segment sum,
// with the step's two global sums in the same launch.
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
// Optional global sums: when `overall_size` and `overall_count` are given,
// the launch also adds the sum of the valid records' key and value bytes and
// the count of valid records into those int64 scalars (the JAX step's
// backends/step.py:341-342, which count every valid record whatever its
// partition).  Each thread keeps both in registers; the block reduces them
// with warp shuffles and adds each with one global atomicAdd.
//
// Bound: the kernel must read 15 B per record (three int32 columns and three
// bool columns) and read and write the 56·P-byte table; at B = 2^18 that is
// 3.9 MB, 1.2 us at 3.35 TB/s.  It does 7·B integer adds.  At that shape
// the bytes do not decide its time: the launch and the chain of latencies
// inside a block (the loads' round trip, the flush, the barrier, the global
// atomics that must land before the kernel ends) do.  chip_smoke.py
// measures its device time beside the bound.
//
// What the old design lost: on the host, every call paid Python checks
// column by column, a `torch.cuda.current_stream()` object, a ten-argument
// ctypes conversion and three CUDA queries for the device, its SM count
// and its shared-memory limit.  On the device, each thread branched on
// `valid[i]` before it loaded the other five columns of the record, so a
// thread had one or two loads in flight and paid two memory round trips per
// record; its 64-bit shared atomics were compare-and-swap loops, and under
// runs of one partition every thread of a block flushed into the same
// seven cells, which made that order about six times slower than the
// round-robin one.
//
// Design now:
// - Host: one packed argument record (one ctypes conversion).  The SM count,
//   the opt-in shared-memory limit, the kernels' occupancy and the dynamic
//   shared-memory attribute (set once, at the largest size the shared path
//   takes) are kept per device in this library.
// - One wave: the grid is the blocks that fit the card at once (occupancy
//   for this table size), or fewer when the batch needs fewer tiles of
//   kUnroll * kThreads records.
// - Loads in flight: each thread loads all six columns of kUnroll records
//   (records t, t + kThreads, ... of its tile, so each warp's loads are
//   coalesced) before it uses any of them, and predicates on `valid` after
//   the loads.
// - Register runs: each thread keeps the running sums of the partition it is
//   on and flushes only when the partition changes.  Under the scan's
//   round-robin order (P divides kThreads) or runs of one partition (what a
//   Kafka fetch delivers) a thread never changes partition.  At the end the
//   warp combines lanes that hold the same partition (a butterfly of
//   shuffles while every pair of lanes agrees), so under round-robin order
//   with P = 16 half the lanes flush, and under runs of one partition one.
// - Shared path (56·P bytes and the block's 256 static bytes fit the opt-in
//   shared memory: P <= 4146 on an H100): a block-private uint64 [P, 7]
//   histogram takes the flushes, then the block adds its nonzero cells into
//   per_partition with one global atomicAdd each.  A 64-bit atomicAdd on
//   shared memory compiles to a compare-and-swap loop on sm_90
//   (ATOMS.CAST.SPIN.64), so each cell is kept as two 32-bit words added
//   with native 32-bit atomics and an explicit carry.  The block zeroes the
//   histogram while its first loads are in flight, and ends with one
//   barrier for the histogram and the sums together.
// - Global path (larger P, up to the packer's 32767): flushes go straight to
//   per_partition with global atomicAdd.
// Records that are not valid, or whose partition lies outside [0, P), add
// nothing to the table (the JAX scatter routes the former to a dropped row
// and drops out-of-range updates; the packer rejects the latter).
// Each column is read one element per thread, so the kernel assumes no
// alignment beyond each column's own element size.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; the
// Python wrapper (ops/counters_update.py) checks the tensors and passes raw
// pointers and PyTorch's current stream.

#include <mutex>

#include "kta_launch.cuh"

// The wrapper's argument record: thirteen little-endian 64-bit fields,
// packed by ops/counters_update.py with struct format "<7Qqq3Qq".  It lies
// outside the anonymous namespace so that the extern "C" entry taking it
// keeps external linkage.
struct KtaUpdateArgs {
  uint64_t per_partition;  // int64[P, 7], updated in place
  uint64_t partition;      // int32[n]
  uint64_t key_len;        // int32[n]
  uint64_t value_len;      // int32[n]
  uint64_t key_null;       // bool[n]
  uint64_t value_null;     // bool[n]
  uint64_t valid;          // bool[n]
  int64_t n;
  int64_t num_parts;
  uint64_t overall_size;   // int64 scalar or 0
  uint64_t overall_count;  // int64 scalar or 0
  uint64_t stream;         // cudaStream_t
  int64_t device;          // the table's CUDA device index
};

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr int kChannels = 7;

struct Run {
  int p;  // partition of the run, -1 when empty
  unsigned long long c[kChannels];
};

__device__ __forceinline__ void run_reset(Run& run, int p) {
  run.p = p;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) run.c[c] = 0;
}

// Adds the run into `table`: the block's shared histogram, or per_partition
// itself (native 64-bit global atomics).  Hopper has no native 64-bit add on
// shared memory (it compiles to a compare-and-swap loop), so a shared cell
// is kept as its low and high 32-bit words, added with native 32-bit
// atomics: the seven low-word adds are issued together, then the thread
// whose add carried out of a low word adds the carry with the high word.
// The pair holds the exact sum modulo 2^64.
template <bool kShared>
__device__ __forceinline__ void run_flush(const Run& run,
                                          unsigned long long* table) {
  if (run.p < 0) return;
  unsigned long long* row = table + (long long)run.p * kChannels;
  if (!kShared) {
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      if (run.c[c] != 0) atomicAdd(row + c, run.c[c]);
    }
    return;
  }
  unsigned int* cell = reinterpret_cast<unsigned int*>(row);
  unsigned int old[kChannels];
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    const unsigned int lo = (unsigned int)run.c[c];
    old[c] = lo != 0 ? atomicAdd(cell + 2 * c, lo) : 0u;
  }
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    const unsigned int lo = (unsigned int)run.c[c];
    const unsigned int hi = (unsigned int)(run.c[c] >> 32) +
                            (old[c] + lo < old[c] ? 1u : 0u);
    if (hi != 0) atomicAdd(cell + 2 * c + 1, hi);
  }
}

// The last flush of every lane, called by the whole warp.  While every pair
// of lanes `o` apart holds the same partition (or one of them an empty run),
// the pair's sums are combined; then only one lane of each combined group
// flushes.
template <bool kShared>
__device__ __forceinline__ void run_flush_warp(Run& run,
                                               unsigned long long* table) {
  int combined = 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int q = __shfl_xor_sync(0xffffffffu, run.p, o);
    if (!__all_sync(0xffffffffu, run.p == q || run.p < 0 || q < 0)) break;
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      run.c[c] += __shfl_xor_sync(0xffffffffu, run.c[c], o);
    }
    run.p = run.p > q ? run.p : q;
    combined |= o;
  }
  if (((int)threadIdx.x & combined) == 0) run_flush<kShared>(run, table);
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1) counters_update_kernel(
    unsigned long long* __restrict__ per_partition,
    const int32_t* __restrict__ partition, const int32_t* __restrict__ key_len,
    const int32_t* __restrict__ value_len, const bool* __restrict__ key_null,
    const bool* __restrict__ value_null, const bool* __restrict__ valid,
    long long n, int num_parts, unsigned long long* __restrict__ overall_size,
    unsigned long long* __restrict__ overall_count) {
  extern __shared__ unsigned long long hist[];
  __shared__ unsigned long long scratch[2][kThreads / 32];
  unsigned long long* table = kShared ? hist : per_partition;
  const int cells = num_parts * kChannels;
  // The shared path zeroes its histogram once its first tile's loads are in
  // flight.
  bool zeroed = !kShared;
  Run run;
  run_reset(run, -1);
  unsigned long long size = 0, count = 0;
  const long long tile = (long long)kUnroll * kThreads;
  // The loop bounds are the block's, so every thread of the block reaches
  // the barriers and the warp-wide flush below together.
  for (long long t0 = (long long)blockIdx.x * tile; t0 < n;
       t0 += (long long)gridDim.x * tile) {
    int p[kUnroll], kl[kUnroll], vl[kUnroll];
    bool ok[kUnroll], kn[kUnroll], vn[kUnroll];
    // Every load of the kUnroll records first ...
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = t0 + threadIdx.x + (long long)k * kThreads;
      if (i < n) {
        ok[k] = valid[i];
        p[k] = partition[i];
        kl[k] = key_len[i];
        vl[k] = value_len[i];
        kn[k] = !key_null[i];
        vn[k] = !value_null[i];
      } else {
        ok[k] = false;
        p[k] = -1;
        kl[k] = vl[k] = 0;
        kn[k] = vn[k] = false;
      }
    }
    if (!zeroed) {
      for (int j = threadIdx.x; j < cells; j += kThreads) hist[j] = 0ull;
      __syncthreads();
      zeroed = true;
    }
    // ... then the adds.
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (!ok[k]) continue;
      // Sign-extend like the JAX int32 -> int64 cast, then wrap in uint64.
      const unsigned long long kb =
          kn[k] ? (unsigned long long)(long long)kl[k] : 0ull;
      const unsigned long long vb =
          vn[k] ? (unsigned long long)(long long)vl[k] : 0ull;
      count += 1ull;
      size += kb + vb;
      if (p[k] < 0 || p[k] >= num_parts) continue;
      if (p[k] != run.p) {
        run_flush<kShared>(run, table);
        run_reset(run, p[k]);
      }
      run.c[0] += 1ull;
      run.c[1] += vn[k] ? 0ull : 1ull;
      run.c[2] += vn[k] ? 1ull : 0ull;
      run.c[3] += kn[k] ? 0ull : 1ull;
      run.c[4] += kn[k] ? 1ull : 0ull;
      run.c[5] += kb;
      run.c[6] += vb;
    }
  }
  if (!zeroed) {
    // A block with no tile (the host launches none): an empty histogram.
    for (int j = threadIdx.x; j < cells; j += kThreads) hist[j] = 0ull;
  }
  run_flush_warp<kShared>(run, table);
  const bool sums = overall_size != nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (sums) {
    size = warp_sum(size);
    count = warp_sum(count);
    if (lane == 0) {
      scratch[0][warp] = size;
      scratch[1][warp] = count;
    }
  }
  // One barrier: the histogram is complete and the warps' sums are written.
  if (kShared || sums) __syncthreads();
  if (sums && warp == 0) {
    size = warp_sum(lane < kThreads / 32 ? scratch[0][lane] : 0ull);
    count = warp_sum(lane < kThreads / 32 ? scratch[1][lane] : 0ull);
    if (lane == 0) {
      if (size != 0) atomicAdd(overall_size, size);
      if (count != 0) atomicAdd(overall_count, count);
    }
  }
  if (kShared) {
    for (int j = threadIdx.x; j < cells; j += kThreads) {
      const unsigned long long v = hist[j];
      if (v != 0) atomicAdd(per_partition + j, v);
    }
  }
}

// What the launch needs to know of a device, read once.
struct DeviceInfo {
  int sms;
  int max_shared_parts;     // largest P of the shared path
  int global_blocks_per_sm; // occupancy of the global path
  // Occupancy of the shared path at the last table size asked for:
  // (shared bytes << 8) | blocks per SM, 0 when none yet.
  std::atomic<unsigned long long> shared_occupancy;
};

std::mutex g_init;
std::atomic<bool> g_ready[kMaxDevices];
DeviceInfo g_info[kMaxDevices];

cudaError_t init_device(int dev) {
  std::lock_guard<std::mutex> lock(g_init);
  if (g_ready[dev].load(std::memory_order_acquire)) return cudaSuccess;
  DeviceInfo& d = g_info[dev];
  int optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&attr, counters_update_kernel<true>);
  }
  if (err != cudaSuccess) return err;
  // The largest dynamic size the shared path takes, set once.
  const int dynamic_max = optin - (int)attr.sharedSizeBytes;
  d.max_shared_parts =
      dynamic_max / (kChannels * (int)sizeof(unsigned long long));
  err = cudaFuncSetAttribute(counters_update_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dynamic_max);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &d.global_blocks_per_sm, counters_update_kernel<false>, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  d.shared_occupancy.store(0, std::memory_order_relaxed);
  g_ready[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace

extern "C" int kta_counters_update(const KtaUpdateArgs* a) {
  if (a->n <= 0) return 0;
  int dev = 0;
  int err = check_device(a->device, &dev);
  if (err != 0) return err;
  if (!g_ready[dev].load(std::memory_order_acquire)) {
    err = init_device(dev);
    if (err != cudaSuccess) return err;
  }
  DeviceInfo& d = g_info[dev];
  const int num_parts = (int)a->num_parts;
  const bool shared = num_parts <= d.max_shared_parts;
  const size_t shared_bytes =
      shared ? (size_t)num_parts * kChannels * sizeof(unsigned long long) : 0;
  int per_sm = d.global_blocks_per_sm;
  if (shared) {
    const unsigned long long cached =
        d.shared_occupancy.load(std::memory_order_relaxed);
    if (cached != 0 && (cached >> 8) == shared_bytes) {
      per_sm = (int)(cached & 0xff);
    } else {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, counters_update_kernel<true>, kThreads, shared_bytes);
      if (err != cudaSuccess) return (int)err;
      d.shared_occupancy.store(((unsigned long long)shared_bytes << 8) |
                                   (unsigned long long)(per_sm & 0xff),
                               std::memory_order_relaxed);
    }
  }
  if (per_sm < 1) per_sm = 1;
  const long long tile = (long long)kUnroll * kThreads;
  long long blocks = (a->n + tile - 1) / tile;
  if (blocks > (long long)per_sm * d.sms) blocks = (long long)per_sm * d.sms;
  auto s = (cudaStream_t)a->stream;
  auto* acc = (unsigned long long*)a->per_partition;
  auto* part = (const int32_t*)a->partition;
  auto* klen = (const int32_t*)a->key_len;
  auto* vlen = (const int32_t*)a->value_len;
  auto* knull = (const bool*)a->key_null;
  auto* vnull = (const bool*)a->value_null;
  auto* ok = (const bool*)a->valid;
  auto* size = (unsigned long long*)a->overall_size;
  auto* count = (unsigned long long*)a->overall_count;
  if (shared) {
    counters_update_kernel<true><<<(unsigned)blocks, kThreads, shared_bytes,
                                   s>>>(acc, part, klen, vlen, knull, vnull,
                                        ok, a->n, num_parts, size, count);
  } else {
    counters_update_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        acc, part, klen, vlen, knull, vnull, ok, a->n, num_parts, size, count);
  }
  return (int)cudaGetLastError();
}
