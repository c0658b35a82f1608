// Alive-bitmap pair apply for Hopper: set or clear one bit per host-deduped
// (slot, aliveness) pair, in place, with one atomic per pair.
//
// Replaces no TPU kernel: the JAX package applies the pairs with an XLA
// scatter-add (kafka_topic_analyzer_tpu/ops/bitmap.py, bitmap_apply_pairs),
// and the port's plain PyTorch version had no bitwise-OR scatter, so it
// built each touched word's set and clear masks by `index_add_` into a
// bitmap-sized int32 accumulator (512 MiB at 2^32 slots), read them back,
// zeroed them and gathered, masked and scattered the words: a dozen launches
// a dispatch and the accumulator resident beside the bitmap.
//
// Why atomics suffice: the host has already resolved last-writer-wins per
// slot (packing.pack_pair_table, native/ingest.cpp), so within one apply
// each live slot appears once.  The bits that land in one word are then
// distinct, and no set meets a clear of the same bit, so atomicOr(bit) for a
// set and atomicAnd(~bit) for a clear commute: applied straight to the words
// in any order they leave (words & ~clear) | set, the reference's result.
// Successive applies (a space-sharded mesh's chunks, the per-row pairs of
// consecutive rows) are ordered by the stream, which keeps last-writer-wins
// across them.
//
// One thread per pair-table entry, grid-stride over the capacity T.  The
// live prefix length `n_pairs` is read from device memory (the pair table's
// header), so the host never waits for it; threads past it return.  Each
// slot is masked to the space shard's range [base, base + span): a slot
// outside it wraps past `span` in the unsigned subtraction and is skipped.
//
// Bound: the kernel reads 5 B a live pair (the u32 slot and the u8 flag)
// and the 4 B header, and read-modify-writes the 32 B sector of each word it
// touches.  A demo audit's dispatch carries T = 262,144 live pairs (a
// 2^18-record row of distinct keys) spread over a 2^32-slot bitmap, so
// nearly every pair touches its own sector: 1.3 MB read and 16.8 MB of
// sectors read and written, 5.4 us at 3.35 TB/s.  The atomics resolve in
// L2 and, on distinct words, hardly contend; their scattered sectors are
// what bounds the kernel.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; the
// Python wrapper (ops/bitmap.py) checks the tensors and passes raw pointers
// and PyTorch's current stream.

#include "kta_launch.cuh"

// The wrapper's argument record: nine little-endian 64-bit fields, packed
// by ops/bitmap.py with struct format "<QQQQqQQQq".  It lies outside the
// anonymous namespace so that the extern "C" entry taking it keeps external
// linkage.
struct KtaPairsArgs {
  uint64_t words;    // int32[W] this space shard's words, updated in place
  uint64_t slot;     // int32[T] u32 slot bit patterns
  uint64_t flag;     // uint8[T] nonzero = the slot's last record had a value
  uint64_t n_pairs;  // int32 scalar: the live prefix length
  int64_t t;         // T, the table's capacity
  uint64_t base;     // the shard's first slot, index * W * 32
  uint64_t span;     // the shard's slots, W * 32
  uint64_t stream;   // cudaStream_t
  int64_t device;    // the tensors' CUDA device index
};

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    bitmap_pairs_kernel(unsigned* __restrict__ words,
                        const unsigned* __restrict__ slot,
                        const unsigned char* __restrict__ flag,
                        const int* __restrict__ n_pairs, long long t,
                        unsigned long long base, unsigned long long span) {
  long long n = *n_pairs;
  if (n > t) n = t;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long s = (unsigned long long)slot[i] - base;
    if (s >= span) continue;
    const unsigned bit = 1u << (unsigned)(s & 31u);
    unsigned* w = words + (s >> 5);
    if (flag[i]) {
      atomicOr(w, bit);
    } else {
      atomicAnd(w, ~bit);
    }
  }
}

}  // namespace

extern "C" int kta_bitmap_apply_pairs(const KtaPairsArgs* a) {
  if (a->t <= 0) return 0;
  int dev = 0, sms = 0;
  int err = check_device(a->device, &dev);
  if (err == 0) err = sm_count(dev, &sms);
  if (err != 0) return err;
  long long blocks = (a->t + kThreads - 1) / kThreads;
  if (blocks > 4LL * sms) blocks = 4LL * sms;
  bitmap_pairs_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)a->stream>>>(
      (unsigned*)a->words, (const unsigned*)a->slot,
      (const unsigned char*)a->flag, (const int*)a->n_pairs, a->t, a->base,
      a->span);
  return (int)cudaGetLastError();
}
