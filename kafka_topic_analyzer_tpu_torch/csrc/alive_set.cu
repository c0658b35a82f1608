// The exact alive-key set for Hopper: an open-addressing hash set keyed by
// the full u32 bitmap slot, with one aliveness bit an entry, in place of the
// 2^bits-slot bitmap where the distinct slots seen are few (ops/alive_set.py
// says when).  Three entries:
//
// - kta_alive_set_apply: apply one host-deduped (slot, aliveness) pair list.
//   A set pair finds its slot's entry or inserts it, and sets its bit; a
//   clear pair clears the bit of an entry that is present and inserts
//   nothing.  The alive count is the number of set bits, so the answer is
//   the bitmap's, bit for bit: fnv32 collisions conflate keys exactly as
//   they do there, and slots at or past 2^bits change nothing, as they
//   change nothing in a bitmap of 2^bits slots.
// - kta_alive_set_rehash: insert every entry of a table into an empty one of
//   twice (or more) its capacity, with its bit (the host's grow).
// - kta_alive_set_count: the alive count (popcount of the bits, plus the
//   bit of slot 0xFFFFFFFF), the entries inserted and the overflow flag,
//   into three u64 (finalize copies 24 bytes, not a dense bitmap).
//
// Replaces no TPU kernel: the JAX package keeps the dense bitmap
// (kafka_topic_analyzer_tpu/ops/bitmap.py) and has no counterpart.
//
// Layout (ops/alive_set.py): keys u32[C], C a power of two, the empty marker
// 0xFFFFFFFF; alive u32[C / 32], entry i's bit is bit i % 32 of word i / 32;
// meta u32[4]: [0] entries inserted, [1] the aliveness of slot 0xFFFFFFFF
// itself (the one slot the empty marker cannot key), [2] nonzero once a
// probe found the table full (the host's sizing keeps it at most 3/4 full,
// so this is a guard, read at finalize, not a path), [3] unused.
//
// Why atomics suffice: the host has already resolved last-writer-wins per
// slot (packing.pack_pair_table, native/ingest.cpp), so within one apply
// each live slot appears once.  Inserts claim an empty entry with atomicCAS
// and probe linearly on (within a 32-byte sector of 8 keys, then across
// sectors); a key, once written, never moves or leaves, so a clear's probe
// meets its entry before any empty one, whatever inserts run beside it.  A
// set ORs and a clear ANDs its own entry's bit; the bits of one apply are
// distinct, so the atomics commute, as bitmap_pairs.cu argues for words.
// Successive applies are ordered by the stream.
//
// One thread a pair-table entry, grid-stride over the capacity T; the live
// prefix length `n_pairs` is read from device memory (the pair table's
// header), so the host never waits for it.  Each warp adds its inserts to
// meta[0] with one atomic.
//
// Bound: a pair reads its u32 slot and u8 flag (5 B) and, at a load of at
// most 1/2, one 32-byte sector of keys for nearly every probe (8 keys a
// sector), which an insert writes back; the bit words' sectors it touches
// are read and written.  A demo audit's dispatch carries T = 262,144 live
// pairs (a 2^18-record row of distinct keys) over a table of 2^24 entries
// (64 MiB, beyond L2): nearly every pair has a key sector of its own, while
// the 2 MiB of bits are nearly all touched.  Every slot present: 1.3 MB +
// 8.4 MB of keys + 2 x 2.1 MB of bits = 13.9 MB, 4.1 us at 3.35 TB/s; every
// slot new: 22.3 MB, 6.7 us (chip_smoke.py counts the sectors of its own
// tables: 13.3 and 21.2 MB).
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; the
// Python wrapper (ops/alive_set.py) checks the tensors and passes raw
// pointers and PyTorch's current stream.

#include "kta_launch.cuh"

// The wrappers' argument records, little-endian 64-bit fields packed by
// ops/alive_set.py.  They lie outside the anonymous namespace so that the
// extern "C" entries taking them keep external linkage.
struct KtaSetApplyArgs {  // "<QQQQQQqQQQq"
  uint64_t keys;     // u32[C], updated in place
  uint64_t alive;    // u32[C / 32], updated in place
  uint64_t meta;     // u32[4], updated in place
  uint64_t slot;     // u32[T] slot bit patterns
  uint64_t flag;     // u8[T] nonzero = the slot's last record had a value
  uint64_t n_pairs;  // int32 scalar: the live prefix length
  int64_t t;         // T, the pair table's capacity
  uint64_t capacity; // C
  uint64_t span;     // 2^bits: slots at or past it change nothing
  uint64_t stream;   // cudaStream_t
  int64_t device;    // the tensors' CUDA device index
};

struct KtaSetRehashArgs {  // "<QQqQQQQq"
  uint64_t old_keys;   // u32[C_old]
  uint64_t old_alive;  // u32[C_old / 32]
  int64_t old_capacity;
  uint64_t keys;       // u32[C], all empty on entry
  uint64_t alive;      // u32[C / 32], all zero on entry
  uint64_t capacity;   // C, above C_old
  uint64_t stream;
  int64_t device;
};

struct KtaSetCountArgs {  // "<QqQQQq"
  uint64_t alive;  // u32[W]
  int64_t words;   // W = C / 32
  uint64_t meta;   // u32[4]
  uint64_t out;    // u64[3], zero on entry: alive count, entries, overflow
  uint64_t stream;
  int64_t device;
};

namespace {

constexpr int kThreads = 256;
constexpr unsigned kEmpty = 0xFFFFFFFFu;
constexpr int kEntries = 0, kTopBit = 1, kFull = 2;
constexpr long long kFullProbe = -2;

// murmur3's 32-bit finalizer: the home entry of a slot.  Slots are fnv32
// values cut to 2^bits, whose low bits alone would cluster.
__device__ __forceinline__ unsigned home(unsigned s) {
  s ^= s >> 16;
  s *= 0x85ebca6bu;
  s ^= s >> 13;
  s *= 0xc2b2ae35u;
  s ^= s >> 16;
  return s;
}

// The entry of slot `s`: found, or claimed when `insert` (adding one to
// *fresh); -1 when absent and not inserted, kFullProbe when a probe of
// every entry found neither the slot nor an empty one.  Keys are read
// through L2 (__ldcg): another thread's insert may have landed there.
__device__ __forceinline__ long long probe(unsigned* keys, unsigned mask,
                                           unsigned s, bool insert,
                                           unsigned* fresh) {
  unsigned p = home(s) & mask;
  for (unsigned long long step = 0; step <= mask; ++step) {
    unsigned k = __ldcg(keys + p);
    if (k == kEmpty) {
      if (!insert) return -1;
      k = atomicCAS(keys + p, kEmpty, s);
      if (k == kEmpty) {
        *fresh += 1;
        return p;
      }
    }
    if (k == s) return p;
    p = (p + 1) & mask;
  }
  return kFullProbe;
}

// Adds each warp's `fresh` to meta[kEntries] and ORs its `full` into
// meta[kFull]; every lane of the warp calls it.
__device__ __forceinline__ void book(unsigned* meta, unsigned fresh,
                                     unsigned full) {
  fresh = __reduce_add_sync(0xffffffffu, fresh);
  full = __reduce_or_sync(0xffffffffu, full);
  if ((threadIdx.x & 31) == 0) {
    if (fresh) atomicAdd(meta + kEntries, fresh);
    if (full) atomicOr(meta + kFull, 1u);
  }
}

__global__ void __launch_bounds__(kThreads)
    alive_set_apply_kernel(unsigned* __restrict__ keys,
                           unsigned* __restrict__ alive,
                           unsigned* __restrict__ meta,
                           const unsigned* __restrict__ slot,
                           const unsigned char* __restrict__ flag,
                           const int* __restrict__ n_pairs, long long t,
                           unsigned mask, unsigned long long span) {
  long long n = *n_pairs;
  if (n > t) n = t;
  unsigned fresh = 0, full = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const unsigned s = slot[i];
    if (s >= span) continue;
    const bool set = flag[i] != 0;
    if (s == kEmpty) {  // one pair at most: its own cell
      meta[kTopBit] = set ? 1u : 0u;
      continue;
    }
    const long long p = probe(keys, mask, s, set, &fresh);
    if (p < 0) {
      full |= p == kFullProbe;
      continue;
    }
    const unsigned bit = 1u << (unsigned)(p & 31);
    if (set) {
      atomicOr(alive + (p >> 5), bit);
    } else {
      atomicAnd(alive + (p >> 5), ~bit);
    }
  }
  book(meta, fresh, full);
}

__global__ void __launch_bounds__(kThreads)
    alive_set_rehash_kernel(const unsigned* __restrict__ old_keys,
                            const unsigned* __restrict__ old_alive,
                            long long old_c, unsigned* __restrict__ keys,
                            unsigned* __restrict__ alive, unsigned mask) {
  unsigned fresh = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < old_c; i += stride) {
    const unsigned s = old_keys[i];
    if (s == kEmpty) continue;
    // A larger table always has room: the probe ends at an empty entry.
    const long long p = probe(keys, mask, s, true, &fresh);
    if ((old_alive[i >> 5] >> (unsigned)(i & 31)) & 1u) {
      atomicOr(alive + (p >> 5), 1u << (unsigned)(p & 31));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    alive_set_count_kernel(const unsigned* __restrict__ alive, long long words,
                           const unsigned* __restrict__ meta,
                           unsigned long long* __restrict__ out) {
  unsigned c = 0;  // a table holds at most 2^25 entries (ops/alive_set.py)
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < words; i += stride) {
    c += __popc(alive[i]);
  }
  const bool first = blockIdx.x == 0 && threadIdx.x == 0;
  if (first) {
    c += meta[kTopBit] & 1u;
    out[1] = meta[kEntries];
    out[2] = meta[kFull];
  }
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(out, (unsigned long long)c);
}

// Blocks for `work` items: enough for one each, at most four a
// multiprocessor (the kernels grid-stride past that).
int grid(int64_t device, long long work, unsigned* blocks) {
  int dev = 0, sms = 0;
  int err = check_device(device, &dev);
  if (err == 0) err = sm_count(dev, &sms);
  if (err != 0) return err;
  long long b = (work + kThreads - 1) / kThreads;
  if (b > 4LL * sms) b = 4LL * sms;
  *blocks = (unsigned)b;
  return 0;
}

}  // namespace

extern "C" int kta_alive_set_apply(const KtaSetApplyArgs* a) {
  if (a->t <= 0) return 0;
  unsigned blocks = 0;
  const int err = grid(a->device, a->t, &blocks);
  if (err != 0) return err;
  alive_set_apply_kernel<<<blocks, kThreads, 0, (cudaStream_t)a->stream>>>(
      (unsigned*)a->keys, (unsigned*)a->alive, (unsigned*)a->meta,
      (const unsigned*)a->slot, (const unsigned char*)a->flag,
      (const int*)a->n_pairs, a->t, (unsigned)(a->capacity - 1), a->span);
  return (int)cudaGetLastError();
}

extern "C" int kta_alive_set_rehash(const KtaSetRehashArgs* a) {
  if (a->old_capacity <= 0) return 0;
  unsigned blocks = 0;
  const int err = grid(a->device, a->old_capacity, &blocks);
  if (err != 0) return err;
  alive_set_rehash_kernel<<<blocks, kThreads, 0, (cudaStream_t)a->stream>>>(
      (const unsigned*)a->old_keys, (const unsigned*)a->old_alive,
      a->old_capacity, (unsigned*)a->keys, (unsigned*)a->alive,
      (unsigned)(a->capacity - 1));
  return (int)cudaGetLastError();
}

extern "C" int kta_alive_set_count(const KtaSetCountArgs* a) {
  unsigned blocks = 0;
  const int err = grid(a->device, a->words > 0 ? a->words : 1, &blocks);
  if (err != 0) return err;
  alive_set_count_kernel<<<blocks, kThreads, 0, (cudaStream_t)a->stream>>>(
      (const unsigned*)a->alive, a->words, (const unsigned*)a->meta,
      (unsigned long long*)a->out);
  return (int)cudaGetLastError();
}
