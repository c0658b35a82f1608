// Native ingest shim of the PyTorch/CUDA port: a copy, unchanged in
// behaviour and ABI (14), of the JAX package's native/ingest.cpp.  Its job
// is the *batch extraction* hot path (SURVEY.md §7 hard parts (a)/(b)):
// produce fixed-width record-metadata columns (lengths, null flags,
// timestamps, key hashes) and packed wire rows at memory bandwidth, so only
// numeric buffers ever cross to the device.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image):
//   - kta_synth_batch:   deterministic synthetic workload generation,
//                        bit-identical to io/synthetic.py::synth_fields
//   - kta_hash_batch:    fnv32(reference variant, src/fnv32.rs:92-101) +
//                        standard fnv64 over packed variable-length keys
//   - kta_version:       ABI version stamp
//
// Build: _build.build_native() (g++ -O3 -march=native, pthreads) into
// build/torch_native/, at first use.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kFnv32Offset = 0x811c9dc5u;
// The reference multiplies by the offset basis, NOT the FNV prime —
// reproduced on purpose (src/fnv32.rs:92-101).
constexpr uint32_t kFnv32Mult = 0x811c9dc5u;
constexpr uint64_t kFnv64Offset = 0xcbf29ce484222325ull;
constexpr uint64_t kFnv64Prime = 0x100000001b3ull;

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

inline uint32_t fnv1a32_ref(const uint8_t* p, int64_t n) {
  uint32_t h = kFnv32Offset;
  for (int64_t i = 0; i < n; ++i) h = (h ^ p[i]) * kFnv32Mult;
  return h;
}

inline uint64_t fnv1a64(const uint8_t* p, int64_t n) {
  uint64_t h = kFnv64Offset;
  for (int64_t i = 0; i < n; ++i) h = (h ^ p[i]) * kFnv64Prime;
  return h;
}

// Both key hashes in ONE pass: the two dependent xor-multiply chains are
// independent of each other, so interleaving them overlaps their
// latencies — per-key hash time approaches max(h32, h64) instead of the
// sum.  Used by every record decoder (per-frame, whole-set, fused).
inline void fnv1a_both(const uint8_t* p, int64_t n, uint32_t* h32,
                       uint64_t* h64) {
  uint32_t a = kFnv32Offset;
  uint64_t b = kFnv64Offset;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t c = p[i];
    a = (a ^ c) * kFnv32Mult;
    b = (b ^ c) * kFnv64Prime;
  }
  *h32 = a;
  *h64 = b;
}

// Parallel-for over [0, n) in contiguous chunks.
template <typename F>
void parallel_for(int64_t n, int threads, F&& body) {
  if (threads <= 1 || n < (1 << 14)) {
    body(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back([&body, lo, hi] { body(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Mirrors io/synthetic.py::SyntheticSpec (wire contract — keep in sync).
struct KtaSynthSpec {
  uint64_t seed;
  int32_t num_partitions;
  int64_t messages_per_partition;
  uint64_t keys_per_partition;
  int32_t key_null_permille;
  int32_t tombstone_permille;
  int32_t value_len_min;
  int32_t value_len_max;
  int32_t key_digits;
  int64_t ts_start_ms;
  int64_t ts_step_ms;
};

int32_t kta_version() { return 14; }

// CRC32-C (Castagnoli) over a byte buffer — Kafka's record-batch checksum.
// Table-driven; the Python fallback (kafka_codec._crc32c) is a per-byte
// interpreter loop that costs ~100 ms/MB, which made check.crcs=true
// impractical.
uint32_t kta_crc32c(const uint8_t* data, int64_t n) {
  // Thread-safe magic static: ctypes releases the GIL, so concurrent first
  // calls are real; a hand-rolled flag would race on the table writes.
  static const std::vector<uint32_t> table = [] {
    std::vector<uint32_t> t(256);
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int k = 0; k < 8; ++k)
        crc = (crc & 1) ? (crc >> 1) ^ 0x82f63b78u : crc >> 1;
      t[i] = crc;
    }
    return t;
  }();
  uint32_t crc = 0xffffffffu;
  for (int64_t i = 0; i < n; ++i)
    crc = table[(crc ^ data[i]) & 0xff] ^ (crc >> 8);
  return crc ^ 0xffffffffu;
}

// Last-writer-wins dedupe of alive-bitmap updates for one batch
// (the host half of the packed transfer's pre-reduction; see
// the port's packing.py).  For each slot = h32 & (2^bits - 1)
// of an active record, only the LAST record's aliveness survives —
// equivalent to replaying insert/remove in record order.  Open-addressing
// hash table over the batch (capacity = next pow2 >= 2n), single pass.
// Outputs at most n (slot, alive) pairs; returns the pair count, or -1 on
// bad arguments.
int64_t kta_dedupe_slots(const uint32_t* h32, const uint8_t* active,
                         const uint8_t* alive, int64_t n, int32_t bits,
                         uint32_t* slot_out, uint8_t* alive_out) {
  if (!h32 || !active || !alive || !slot_out || !alive_out || n < 0 ||
      bits < 1 || bits > 32)
    return -1;
  const uint32_t mask =
      bits == 32 ? 0xffffffffu : ((1u << bits) - 1u);
  size_t cap = 16;
  while (cap < static_cast<size_t>(n) * 2) cap <<= 1;
  const size_t cap_mask = cap - 1;
  // table: index into out arrays + 1; 0 = empty.
  std::vector<int64_t> table(cap, 0);
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!active[i]) continue;
    const uint32_t slot = h32[i] & mask;
    size_t pos = (splitmix64(slot) & cap_mask);
    for (;;) {
      int64_t entry = table[pos];
      if (entry == 0) {
        table[pos] = count + 1;
        slot_out[count] = slot;
        alive_out[count] = alive[i];
        ++count;
        break;
      }
      if (slot_out[entry - 1] == slot) {
        alive_out[entry - 1] = alive[i];  // later record wins
        break;
      }
      pos = (pos + 1) & cap_mask;
    }
  }
  return count;
}

// Generate records for global indices [lo, hi) over the partition list
// `parts` (round-robin: g -> parts[g % nparts] at offset g / nparts),
// exactly like SyntheticSource.batches.  All output arrays have hi-lo
// elements.  Returns 0 on success.
int32_t kta_synth_batch(const KtaSynthSpec* spec,
                        const int32_t* parts, int32_t nparts,
                        int64_t lo, int64_t hi, int32_t threads,
                        int32_t* partition_out, int32_t* key_len_out,
                        int32_t* value_len_out, uint8_t* key_null_out,
                        uint8_t* value_null_out, int64_t* ts_s_out,
                        uint32_t* h32_out, uint64_t* h64_out,
                        uint8_t* valid_out) {
  if (!spec || !parts || nparts <= 0 || hi < lo) return -1;
  const int64_t n = hi - lo;
  const KtaSynthSpec s = *spec;
  const int key_len_total = 1 + s.key_digits;

  // Stream bases depend only on the partition — mix once per slot of the
  // round-robin, not once per record.
  std::vector<uint64_t> bases(nparts);
  for (int32_t j = 0; j < nparts; ++j)
    bases[j] = splitmix64(s.seed ^ (static_cast<uint64_t>(parts[j]) << 40));

  parallel_for(n, threads, [&](int64_t a, int64_t b) {
    uint8_t keybuf[64];
    keybuf[0] = 'k';
    for (int64_t i = a; i < b; ++i) {
      const int64_t g = lo + i;
      const int32_t p = parts[g % nparts];
      const int64_t o = g / nparts;
      // Record o is the o-th output of a SplitMix64 stream with a mixed
      // per-partition base (see io/synthetic.py — wire contract).
      const uint64_t x = splitmix64(bases[g % nparts] +
                                    static_cast<uint64_t>(o) * 0x9e3779b97f4a7c15ull);

      const bool key_null =
          static_cast<int64_t>(x % 1000ull) < s.key_null_permille;
      const bool value_null =
          static_cast<int64_t>((x >> 10) % 1000ull) < s.tombstone_permille;
      const uint64_t local = (x >> 20) % s.keys_per_partition;
      const uint64_t key_id =
          static_cast<uint64_t>(p) +
          static_cast<uint64_t>(s.num_partitions) * local;
      const uint64_t vspread =
          static_cast<uint64_t>(s.value_len_max - s.value_len_min + 1);
      const int32_t vlen =
          value_null ? 0
                     : s.value_len_min +
                           static_cast<int32_t>((x >> 40) % vspread);

      partition_out[i] = p;
      value_len_out[i] = vlen;
      key_null_out[i] = key_null ? 1 : 0;
      value_null_out[i] = value_null ? 1 : 0;
      // floor division like numpy (`//`): values are non-negative here.
      ts_s_out[i] = (s.ts_start_ms + o * s.ts_step_ms) / 1000;
      valid_out[i] = 1;

      if (key_null) {
        key_len_out[i] = 0;
        h32_out[i] = 0;
        h64_out[i] = 0;
      } else {
        key_len_out[i] = key_len_total;
        uint64_t rem = key_id;
        for (int d = s.key_digits - 1; d >= 0; --d) {
          keybuf[1 + d] = static_cast<uint8_t>('0' + (rem % 10));
          rem /= 10;
        }
        h32_out[i] = fnv1a32_ref(keybuf, key_len_total);
        h64_out[i] = fnv1a64(keybuf, key_len_total);
      }
    }
  });
  return 0;
}

// Hash n variable-length byte slices packed in `data` at `offsets`
// (offsets[n] marks the end).  Used by the Kafka wire source to hash real
// key bytes off the fetch path.
int32_t kta_hash_batch(const uint8_t* data, const int64_t* offsets, int64_t n,
                       int32_t threads, uint32_t* h32_out, uint64_t* h64_out) {
  if (!data || !offsets || n < 0) return -1;
  parallel_for(n, threads, [&](int64_t a, int64_t b) {
    for (int64_t i = a; i < b; ++i) {
      const int64_t off = offsets[i];
      const int64_t len = offsets[i + 1] - off;
      h32_out[i] = fnv1a32_ref(data + off, len);
      h64_out[i] = fnv1a64(data + off, len);
    }
  });
  return 0;
}

// Kafka RecordBatch v2 record decoding: parse one decompressed batch
// payload into fixed-width SoA columns, hashing key bytes inline — the hot
// half of the wire client (the Python per-record generator measures ~225k
// records/s; this decodes at tens of millions).  The caller (io/native.py /
// kafka_codec.iter_batch_frames) has already handled framing, CRC and
// decompression.  Returns the number of records decoded, or -1 on malformed
// input (caller falls back to the Python decoder for a precise error).
int64_t kta_decode_records(const uint8_t* payload, int64_t payload_len,
                           int32_t num_records, int64_t base_offset,
                           int64_t first_ts_ms,
                           int64_t* offsets_out, int64_t* ts_ms_out,
                           int32_t* key_len_out, int32_t* value_len_out,
                           uint8_t* key_null_out, uint8_t* value_null_out,
                           uint32_t* h32_out, uint64_t* h64_out);

}  // extern "C"

namespace {
// Zigzag varint over [pos, len); false on truncation/overflow.
inline bool read_zigzag(const uint8_t* p, int64_t len, int64_t& pos,
                        int64_t& out) {
  uint64_t z = 0;
  int shift = 0;
  while (pos < len) {
    const uint8_t b = p[pos++];
    z |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      out = static_cast<int64_t>(z >> 1) ^ -static_cast<int64_t>(z & 1);
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}
}  // namespace

extern "C" int64_t kta_decode_records(
    const uint8_t* payload, int64_t payload_len, int32_t num_records,
    int64_t base_offset, int64_t first_ts_ms,
    int64_t* offsets_out, int64_t* ts_ms_out,
    int32_t* key_len_out, int32_t* value_len_out,
    uint8_t* key_null_out, uint8_t* value_null_out,
    uint32_t* h32_out, uint64_t* h64_out) {
  if (!payload || payload_len < 0 || num_records < 0) return -1;
  int64_t pos = 0;
  for (int32_t i = 0; i < num_records; ++i) {
    int64_t length;
    if (!read_zigzag(payload, payload_len, pos, length)) return -1;
    // Overflow-safe: a hostile 10-byte varint can encode ~2^63 and
    // `pos + length` would overflow int64 (UB) and bypass the bound.
    if (length < 0 || length > payload_len - pos) return -1;
    const int64_t rec_end = pos + length;
    if (pos >= rec_end) return -1;
    ++pos;  // record attributes
    int64_t ts_delta, off_delta, klen, vlen;
    if (!read_zigzag(payload, rec_end, pos, ts_delta)) return -1;
    if (!read_zigzag(payload, rec_end, pos, off_delta)) return -1;
    if (!read_zigzag(payload, rec_end, pos, klen)) return -1;
    if (klen < 0) {
      key_null_out[i] = 1;
      key_len_out[i] = 0;
      h32_out[i] = 0;
      h64_out[i] = 0;
    } else {
      if (klen > rec_end - pos || klen > 0x7fffffff) return -1;
      key_null_out[i] = 0;
      key_len_out[i] = static_cast<int32_t>(klen);
      fnv1a_both(payload + pos, klen, h32_out + i, h64_out + i);
      pos += klen;
    }
    if (!read_zigzag(payload, rec_end, pos, vlen)) return -1;
    if (vlen < 0) {
      value_null_out[i] = 1;
      value_len_out[i] = 0;
    } else {
      if (vlen > rec_end - pos || vlen > 0x7fffffff) return -1;
      value_null_out[i] = 0;
      value_len_out[i] = static_cast<int32_t>(vlen);
      pos += vlen;  // value bytes never needed (SURVEY.md §3.4)
    }
    int64_t nheaders;
    if (!read_zigzag(payload, rec_end, pos, nheaders)) return -1;
    if (nheaders < 0) return -1;
    for (int64_t h = 0; h < nheaders; ++h) {
      int64_t hk, hv;
      if (!read_zigzag(payload, rec_end, pos, hk)) return -1;
      if (hk < 0 || hk > rec_end - pos) return -1;
      pos += hk;
      if (!read_zigzag(payload, rec_end, pos, hv)) return -1;
      if (hv > 0) {
        if (hv > rec_end - pos) return -1;
        pos += hv;
      }
    }
    offsets_out[i] = base_offset + off_delta;
    ts_ms_out[i] = first_ts_ms + ts_delta;
    pos = rec_end;  // tolerate unknown trailing record fields
  }
  return num_records;
}

namespace {

inline int64_t be64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) v = (v << 8) | p[i];
  return static_cast<int64_t>(v);
}
inline int32_t be32(const uint8_t* p) {
  uint32_t v = 0;
  for (int i = 0; i < 4; ++i) v = (v << 8) | p[i];
  return static_cast<int32_t>(v);
}
inline int16_t be16(const uint8_t* p) {
  return static_cast<int16_t>((uint16_t(p[0]) << 8) | p[1]);
}

// One RecordBatch v2 frame header at `pos` of the NATIVE-decodable kind:
// complete, magic 2, uncompressed, sane record count, CRC ok (when asked).
// Returns true and fills the fields; false means the caller must stop the
// native walk here (a Python path decodes the frame — compressed, legacy
// MessageSet, truncated tail — or raises the precise protocol error).
struct FrameHeader {
  int64_t base_offset;
  int64_t first_ts;
  int64_t end;           // byte offset one past the frame
  int64_t payload_pos;   // first record byte
  int64_t covered_end;   // base_offset + max(last_offset_delta, 0) + 1
  int32_t num_records;
  bool control;          // txn commit/abort markers: skip, offsets count
};

inline bool native_frame_at(const uint8_t* buf, int64_t len, int64_t pos,
                            int32_t verify_crc, FrameHeader* fh) {
  if (pos + 61 > len) return false;          // header incomplete
  const int64_t batch_length = be32(buf + pos + 8);
  if (batch_length <= 0) return false;
  const int64_t end = pos + 12 + batch_length;
  if (end > len) return false;               // partial trailing frame
  if (buf[pos + 16] != 2) return false;      // legacy MessageSet v0/v1
  const int16_t attributes = be16(buf + pos + 21);
  if ((attributes & 0x07) != 0) return false;  // compressed
  fh->control = (attributes & 0x20) != 0;
  const int32_t num_records = be32(buf + pos + 57);
  const int64_t payload_pos = pos + 61;
  // Untrusted count: a valid record needs >= 7 payload bytes.
  if (num_records < 0 || num_records > (end - payload_pos) / 7) return false;
  if (verify_crc) {
    const uint32_t crc = static_cast<uint32_t>(be32(buf + pos + 17));
    if (kta_crc32c(buf + pos + 21, end - (pos + 21)) != crc) return false;
  }
  const int32_t last_offset_delta = be32(buf + pos + 23);
  fh->base_offset = be64(buf + pos);
  fh->first_ts = be64(buf + pos + 27);
  fh->end = end;
  fh->payload_pos = payload_pos;
  fh->num_records = num_records;
  fh->covered_end =
      fh->base_offset + (last_offset_delta > 0 ? last_offset_delta : 0) + 1;
  return true;
}

}  // namespace

// Count the records in the native-decodable PREFIX of a record set (a
// Fetch response's per-partition records field): consecutive complete,
// uncompressed, magic-2 frames.  The count sizes the caller's output
// arrays for kta_decode_record_set; the walk is a header jump per frame
// (no record parsing), so it costs ~nothing next to the decode.
extern "C" int64_t kta_scan_record_set(const uint8_t* buf, int64_t len,
                                       int32_t verify_crc,
                                       int64_t* consumed_out,
                                       int64_t* covered_out) {
  if (!buf || len < 0) return -1;
  int64_t pos = 0, total = 0, covered = -1;
  FrameHeader fh;
  while (native_frame_at(buf, len, pos, verify_crc, &fh)) {
    if (!fh.control) total += fh.num_records;  // markers aren't messages
    if (fh.covered_end > covered) covered = fh.covered_end;
    pos = fh.end;
  }
  if (consumed_out) *consumed_out = pos;
  if (covered_out) *covered_out = covered;
  return total;
}

// Decode the native-decodable prefix of a record set in ONE call: every
// frame's records into contiguous SoA columns (the per-frame
// kta_decode_records core, pointer-shifted per frame).  Replaces the
// per-frame Python loop of header parse + ctypes call + numpy slicing —
// the wire client's remaining hot-path overhead after round 1 made the
// record decode itself native (io/kafka_wire.py::batches).
// Returns records decoded (== kta_scan_record_set's count), or -1 on a
// malformed frame (callers re-walk with the Python decoder for the
// precise error).  consumed_out: bytes of prefix handled; covered_end_out:
// max over frames of (base_offset + last_offset_delta + 1), the
// compaction-aware scan position advance.
extern "C" int64_t kta_decode_record_set(
    const uint8_t* buf, int64_t len, int32_t verify_crc, int64_t capacity,
    int64_t* offsets_out, int64_t* ts_ms_out,
    int32_t* key_len_out, int32_t* value_len_out,
    uint8_t* key_null_out, uint8_t* value_null_out,
    uint32_t* h32_out, uint64_t* h64_out,
    int64_t* consumed_out, int64_t* covered_end_out) {
  if (!buf || len < 0 || capacity < 0) return -1;
  int64_t pos = 0, n = 0, covered = -1;
  FrameHeader fh;
  while (native_frame_at(buf, len, pos, verify_crc, &fh)) {
    if (fh.control) {  // txn markers: no records, offsets still covered
      if (fh.covered_end > covered) covered = fh.covered_end;
      pos = fh.end;
      continue;
    }
    if (n + fh.num_records > capacity) return -1;
    const int64_t got = kta_decode_records(
        buf + fh.payload_pos, fh.end - fh.payload_pos, fh.num_records,
        fh.base_offset, fh.first_ts,
        offsets_out + n, ts_ms_out + n, key_len_out + n, value_len_out + n,
        key_null_out + n, value_null_out + n, h32_out + n, h64_out + n);
    if (got != fh.num_records) return -1;
    n += got;
    if (fh.covered_end > covered) covered = fh.covered_end;
    pos = fh.end;
  }
  if (consumed_out) *consumed_out = pos;
  if (covered_end_out) *covered_end_out = covered;
  return n;
}

namespace {
// Wire-v5 full-batch packer (combiner rows) — defined after the fused
// row-layout machinery it shares with the incremental packers.
int64_t pack_batch_v5(
    const int32_t* partition, const int32_t* key_len, const int32_t* value_len,
    const uint8_t* key_null, const uint8_t* value_null, const int64_t* ts_s,
    const uint32_t* h32, const uint64_t* h64,
    int64_t n_valid, int64_t batch_size, int32_t num_partitions,
    int32_t with_alive, int32_t alive_bits, int32_t with_hll, int32_t hll_p,
    int32_t hll_rows, int32_t value_len_cap, int32_t q_rows,
    int32_t q_nbuckets, const int64_t* q_edges, uint8_t* out,
    int64_t out_cap);
}  // namespace

// Fused batch packing: RecordBatch SoA columns -> wire-format-v4 buffer
// (the port's packing.py), including the host pre-reductions
// (per-partition ts min/max table, last-writer-wins bitmap dedupe via
// kta_dedupe_slots' table, and the HLL reduction — global register table
// in mode 2, per-record (bucket, rho) pairs in mode 1).  One C++ pass
// replaces several numpy conversions on the per-batch hot path.  Layout
// contract lives in packing.py; keep in sync (HEADER 16B; sections
// p i16[B] | klen u16[B] | vlen u32[B] | flags u8[B] | ts_minmax i64[2P] |
// sz_minmax i64[2P] | [slot u32[B] | alive u8[B]] |
// [hll: regs u8[rows << p] (mode 2) OR idx u16[B] | rho u8[B] (mode 1)]).
// wire_v5 selects the combiner layout instead (packing.py wire v5): the
// four per-record columns are replaced by a per-partition counter-delta
// table i64[P*7] (+ an optional DDSketch bucket table i64[q_rows*(nb+2)]
// keyed by the shared integer edge table q_edges), with_hll gains mode 3
// (flat u32 idx = partition << p | bucket, v5's per-partition pair form).
// Returns total bytes written, or -1 on error (including key_len > u16 /
// partition out of i16/num_partitions range — mirrors pack_batch's
// validation).
extern "C" int64_t kta_pack_batch(
    const int32_t* partition, const int32_t* key_len, const int32_t* value_len,
    const uint8_t* key_null, const uint8_t* value_null, const int64_t* ts_s,
    const uint32_t* h32, const uint64_t* h64,
    int64_t n_valid, int64_t batch_size, int32_t num_partitions,
    int32_t with_alive, int32_t alive_bits, int32_t with_hll, int32_t hll_p,
    int32_t hll_rows,
    int32_t value_len_cap,
    int32_t wire_v5, int32_t q_rows, int32_t q_nbuckets,
    const int64_t* q_edges,
    uint8_t* out, int64_t out_cap) {
  if (n_valid < 0 || n_valid > batch_size) return -1;
  if (num_partitions <= 0) return -1;
  // with_alive == 2 (pairs-to-scratch compaction) is a fused-row mode:
  // this whole-batch packer has no scratch to emit into — the Python
  // caller packs with alive OFF and dedupes the columns separately
  // (packing.batch_alive_pairs).
  if (with_alive != 0 && with_alive != 1) return -1;
  if (wire_v5)
    return pack_batch_v5(
        partition, key_len, value_len, key_null, value_null, ts_s, h32, h64,
        n_valid, batch_size, num_partitions, with_alive, alive_bits, with_hll,
        hll_p, hll_rows, value_len_cap, q_rows, q_nbuckets, q_edges, out,
        out_cap);
  const int64_t b = batch_size;
  const int64_t P = num_partitions;
  // Wire format v4: the per-record i64 ts column is replaced by TWO [2P]
  // per-partition min/max tables — timestamps and (tombstone-excluded)
  // message sizes (packing.py::_sections rationale).
  int64_t need = 16 + b * (2 + 2 + 4 + 1) + 2 * (2 * P * 8);
  if (with_alive) need += b * 5;
  // with_hll: 0 = off, 1 = per-record pairs, 2 = host-reduced register
  // table of hll_rows << hll_p bytes (wire v3; rows = 1 global or P
  // per-partition — python's packing.hll_table_rows decides).
  if (with_hll == 1) need += b * 3;
  if (with_hll == 2) {
    // Per-row tables index by partition id: rows must cover every id the
    // (validated) partition column can carry, or tbl[row << p | idx]
    // writes past the section.
    if (hll_rows < 1 || (hll_rows > 1 && hll_rows < num_partitions))
      return -1;
    need += int64_t(hll_rows) << hll_p;
  }
  if (need > out_cap) return -1;

  std::memset(out, 0, need);
  int64_t pos = 16;
  // Section base pointers stay uint8_t*; elements are stored via memcpy —
  // sections are only naturally aligned when batch_size is a multiple of 8,
  // and typed stores through misaligned pointers are UB.
  uint8_t* p16 = out + pos;
  pos += b * 2;
  uint8_t* kl16 = out + pos;
  pos += b * 2;
  uint8_t* vl32 = out + pos;
  pos += b * 4;
  uint8_t* fl8 = out + pos;
  pos += b;
  uint8_t* tsmm64 = out + pos;
  pos += 2 * P * 8;
  uint8_t* szmm64 = out + pos;
  pos += 2 * P * 8;

  auto store = [](uint8_t* base, int64_t idx, auto v) {
    std::memcpy(base + idx * static_cast<int64_t>(sizeof(v)), &v, sizeof(v));
  };

  const int32_t vcap =
      value_len_cap > 0 ? value_len_cap : 0x7fffffff;
  std::atomic<bool> bad{false};
  parallel_for(n_valid, 8, [&](int64_t a, int64_t e) {
    for (int64_t i = a; i < e; ++i) {
      if (partition[i] < 0 || partition[i] > 0x7fff ||
          partition[i] >= num_partitions ||
          key_len[i] < 0 || key_len[i] > 0xffff ||
          value_len[i] < 0 || value_len[i] > vcap) {
        bad.store(true);
        return;
      }
      store(p16, i, static_cast<int16_t>(partition[i]));
      store(kl16, i, static_cast<uint16_t>(key_len[i]));
      store(vl32, i, static_cast<uint32_t>(value_len[i]));
      fl8[i] = (key_null[i] ? 1 : 0) | (value_null[i] ? 2 : 0);
    }
  });
  if (bad.load()) return -1;

  {
    // Per-partition ts min/max AND (tombstone-excluded) message-size
    // min/max over the valid prefix: identity-filled, single sequential
    // pass (~1-2 ns/record; not worth the thread fan-out).  Size
    // identities are I64_MAX / 0, matching the reference's `largest`
    // starting at 0 (src/metric.rs:34, :249-251).
    std::vector<int64_t> mm(2 * P), sz(2 * P);
    for (int64_t r = 0; r < P; ++r) {
      mm[r] = INT64_MAX;
      mm[P + r] = INT64_MIN;
      sz[r] = INT64_MAX;
      sz[P + r] = 0;
    }
    for (int64_t i = 0; i < n_valid; ++i) {
      const int64_t r = partition[i];
      const int64_t t = ts_s[i];
      if (t < mm[r]) mm[r] = t;
      if (t > mm[P + r]) mm[P + r] = t;
      if (!value_null[i]) {
        const int64_t size =
            (key_null[i] ? 0 : static_cast<int64_t>(key_len[i])) +
            static_cast<int64_t>(value_len[i]);
        if (size < sz[r]) sz[r] = size;
        if (size > sz[P + r]) sz[P + r] = size;
      }
    }
    std::memcpy(tsmm64, mm.data(), 2 * P * 8);
    std::memcpy(szmm64, sz.data(), 2 * P * 8);
  }

  int64_t n_pairs = 0;
  if (with_alive) {
    uint8_t* slot32 = out + pos;
    pos += b * 4;
    uint8_t* alive8 = out + pos;
    pos += b;
    if (n_valid > 0) {
      // active = valid & key non-null; alive = value non-null.  Dedupe into
      // aligned temporaries, then memcpy into the (possibly unaligned)
      // section.  (Empty batches skip this entirely — sharded scans pack
      // empty shard batches every step.)
      std::vector<uint8_t> active(n_valid), alive(n_valid);
      for (int64_t i = 0; i < n_valid; ++i) {
        active[i] = key_null[i] ? 0 : 1;
        alive[i] = value_null[i] ? 0 : 1;
      }
      std::vector<uint32_t> slots(n_valid);
      std::vector<uint8_t> flags(n_valid);
      n_pairs = kta_dedupe_slots(h32, active.data(), alive.data(), n_valid,
                                 alive_bits, slots.data(), flags.data());
      if (n_pairs < 0) return -1;
      std::memcpy(slot32, slots.data(), n_pairs * 4);
      std::memcpy(alive8, flags.data(), n_pairs);
    }
  }
  if (with_hll == 1) {
    uint8_t* idx16 = out + pos;
    pos += b * 2;
    uint8_t* rho8 = out + pos;
    pos += b;
    const int p = hll_p;
    parallel_for(n_valid, 8, [&](int64_t a, int64_t e) {
      for (int64_t i = a; i < e; ++i) {
        if (key_null[i]) {
          store(idx16, i, static_cast<uint16_t>(0));
          rho8[i] = 0;
          continue;
        }
        const uint64_t h = splitmix64(h64[i]);
        store(idx16, i, static_cast<uint16_t>(h >> (64 - p)));
        const uint64_t rest = h << p;
        rho8[i] = rest == 0
                      ? static_cast<uint8_t>(64 - p + 1)
                      : static_cast<uint8_t>(__builtin_clzll(rest) + 1);
      }
    });
  } else if (with_hll == 2) {
    // Register table: scatter-max on the host's cache-resident
    // u8[rows << p] (64 KB at p=16 global), sequential single pass — the
    // device then merges it elementwise.  Row 0 for the global sketch;
    // the record's partition row when per-partition registers fit the
    // table budget.  (The memset above already zeroed it.)
    uint8_t* tbl = out + pos;
    const int p = hll_p;
    const bool per_row = hll_rows > 1;
    pos += int64_t(hll_rows) << p;
    for (int64_t i = 0; i < n_valid; ++i) {
      if (key_null[i]) continue;
      const uint64_t h = splitmix64(h64[i]);
      const int64_t row = per_row ? partition[i] : 0;
      const int64_t idx = (row << p) | static_cast<int64_t>(h >> (64 - p));
      const uint64_t rest = h << p;
      const uint8_t rho =
          rest == 0 ? static_cast<uint8_t>(64 - p + 1)
                    : static_cast<uint8_t>(__builtin_clzll(rest) + 1);
      if (rho > tbl[idx]) tbl[idx] = rho;
    }
  }

  // Header: n_valid i32 | n_pairs i32 | reserved.
  const int32_t hv = static_cast<int32_t>(n_valid);
  const int32_t hp = static_cast<int32_t>(n_pairs);
  std::memcpy(out, &hv, 4);
  std::memcpy(out + 4, &hp, 4);
  return need;
}

// ---------------------------------------------------------------------------
// Fused decode→pack: one pass from raw fetch bytes to wire-v4 packed rows.
//
// The chained hot path is kta_decode_record_set (wire bytes → eight SoA
// columns) followed by kta_pack_batch (columns → wire-v4 buffer): every
// record's metadata is written to memory once and read back once purely to
// move between the two calls.  The fused entry points below append records
// STRAIGHT into a caller-supplied wire-v4 row as they are decoded — the SoA
// intermediate never exists.  Because a row outlives a single call (record
// sets are smaller or larger than one batch), append state persists in a
// caller-owned int64 scratch:
//
//   scratch[0] = n        records appended to the row so far (the cursor;
//                         becomes header n_valid)
//   scratch[1] = n_pairs  alive-dedupe pairs emitted (header n_pairs)
//   scratch[2] = cap      dedupe table capacity (0 when alive is off)
//   scratch[3..3+cap)     open-addressing LWW table (pair index + 1; 0 empty)
//
// The dedupe table persisting across appends is what makes incremental
// packing exact: output pair ORDER is first-occurrence record order —
// independent of table capacity — so a row built by many appends is
// byte-identical to kta_pack_batch over the same records (asserted by
// tests/test_fused.py).
//
// Error contract (mirrors the taxonomy io/native.py documents):
//   >= 0  records appended
//   -1    bad arguments / layout mismatch
//   -2    pack-range violation (a decoded value the wire-v4 layout cannot
//         carry: key_len > u16, value_len > cap, partition out of range) —
//         detail[0] = field code (0 klen / 1 vlen / 2 partition),
//         detail[1] = offending value.  The Python wrapper re-raises the
//         same ValueError the numpy packer would.
// A *malformed frame* is NOT an error here: the walk stops at the frame
// boundary exactly like kta_scan_record_set, and the caller's per-frame
// Python chain classifies it precisely (CorruptFrameError taxonomy).
// Frames are validated in a store-free pre-pass before any append, so a
// frame either appends completely or not at all — corruption can never
// leave half a frame committed to a row.

namespace {

struct PackRowLayout {
  int64_t b;
  int64_t P;
  int32_t with_alive;
  int32_t alive_bits;
  int32_t with_hll;  // 0 off, 1 u16 pairs, 2 register table, 3 u32 flat
                     // pairs (v5: partition << p | bucket)
  int32_t hll_p;
  int32_t hll_rows;
  int32_t vcap;
  int32_t wire_v5;   // combiner layout: counts table replaces the columns
  int32_t q_rows;    // DDSketch rows (0 = no quant section; v5 only)
  int32_t q_nbuckets;            // log buckets (section adds +2)
  const int64_t* q_edges;        // shared integer bucket edge table
  int64_t need;
  // Section base pointers (uint8_t*: sections are only naturally aligned
  // when batch_size is a multiple of 8 — all element access via memcpy).
  uint8_t *p16, *kl16, *vl32, *fl8, *tsmm, *szmm;
  uint8_t *cnt64;          // v5: i64[P * 7] counter deltas
  uint8_t *slot32, *alive8;
  uint8_t *hll_a, *hll_b;  // idx/rho (modes 1/3) or regs/- (mode 2)
  uint8_t *q64;            // v5: i64[q_rows * (q_nbuckets + 2)]
};

inline bool pack_row_layout(uint8_t* out, int64_t out_cap, int64_t b,
                            int32_t P, int32_t with_alive, int32_t alive_bits,
                            int32_t with_hll, int32_t hll_p, int32_t hll_rows,
                            int32_t value_len_cap, int32_t wire_v5,
                            int32_t q_rows, int32_t q_nbuckets,
                            const int64_t* q_edges, PackRowLayout* r) {
  if (!out || b < 0 || P <= 0 || P > 0x7fff) return false;
  if (with_alive < 0 || with_alive > 2) return false;
  if (with_alive && (alive_bits < 1 || alive_bits > 32)) return false;
  if (with_alive == 2 && !wire_v5) return false;  // compaction is v5-only
  if (with_hll == 3 && !wire_v5) return false;  // flat pairs are v5-only
  if (q_rows > 0 && (!wire_v5 || !q_edges || q_nbuckets < 1)) return false;
  if (q_rows > 1 && q_rows < P) return false;  // rows index by partition
  int64_t need = 16 + 2 * (2 * int64_t(P) * 8);
  if (wire_v5)
    need += int64_t(P) * 7 * 8;
  else
    need += b * (2 + 2 + 4 + 1);
  // with_alive == 2 (compaction): the dedupe table still runs, but the
  // pairs divert to a caller-scratch region (attach_scratch_pairs) and
  // the row carries NO pair sections — the dispatch-level merged pair
  // table ships them instead (packing.pack_pair_table).
  if (with_alive == 1) need += b * 5;
  if (with_hll == 1) need += b * 3;
  if (with_hll == 3) need += b * 5;
  if (with_hll == 2) {
    if (hll_rows < 1 || (hll_rows > 1 && hll_rows < P)) return false;
    need += int64_t(hll_rows) << hll_p;
  }
  if (q_rows > 0) need += int64_t(q_rows) * (int64_t(q_nbuckets) + 2) * 8;
  if (need > out_cap) return false;
  r->b = b;
  r->P = P;
  r->with_alive = with_alive;
  r->alive_bits = alive_bits;
  r->with_hll = with_hll;
  r->hll_p = hll_p;
  r->hll_rows = hll_rows;
  r->vcap = value_len_cap > 0 ? value_len_cap : 0x7fffffff;
  r->wire_v5 = wire_v5;
  r->q_rows = q_rows;
  r->q_nbuckets = q_nbuckets;
  r->q_edges = q_edges;
  r->need = need;
  int64_t pos = 16;
  r->p16 = r->kl16 = r->vl32 = r->fl8 = r->cnt64 = nullptr;
  if (wire_v5) {
    r->cnt64 = out + pos;
    pos += int64_t(P) * 7 * 8;
  } else {
    r->p16 = out + pos;
    pos += b * 2;
    r->kl16 = out + pos;
    pos += b * 2;
    r->vl32 = out + pos;
    pos += b * 4;
    r->fl8 = out + pos;
    pos += b;
  }
  r->tsmm = out + pos;
  pos += 2 * P * 8;
  r->szmm = out + pos;
  pos += 2 * P * 8;
  r->slot32 = r->alive8 = nullptr;
  if (with_alive == 1) {
    r->slot32 = out + pos;
    pos += b * 4;
    r->alive8 = out + pos;
    pos += b;
  }
  r->hll_a = r->hll_b = nullptr;
  if (with_hll == 1) {
    r->hll_a = out + pos;  // idx u16[B]
    pos += b * 2;
    r->hll_b = out + pos;  // rho u8[B]
    pos += b;
  } else if (with_hll == 3) {
    r->hll_a = out + pos;  // idx u32[B] (row << p | bucket)
    pos += b * 4;
    r->hll_b = out + pos;  // rho u8[B]
    pos += b;
  } else if (with_hll == 2) {
    r->hll_a = out + pos;  // regs u8[rows << p]
    pos += int64_t(hll_rows) << hll_p;
  }
  r->q64 = nullptr;
  if (q_rows > 0) {
    r->q64 = out + pos;
    pos += int64_t(q_rows) * (int64_t(q_nbuckets) + 2) * 8;
  }
  return true;
}

inline int64_t pack_scratch_cap(int64_t b, int32_t with_alive,
                                int32_t alive_bits) {
  if (!with_alive) return 0;
  // The table can only ever hold min(b, 2^bits) distinct slots; sizing
  // by that instead of b keeps it cache-resident for practical bitmap
  // sizes (capacity changes probe POSITIONS, never the first-occurrence
  // output order, so rows stay byte-identical to kta_dedupe_slots).
  int64_t distinct = b;
  if (alive_bits < 62 && (int64_t(1) << alive_bits) < distinct)
    distinct = int64_t(1) << alive_bits;
  int64_t cap = 16;
  while (cap < distinct * 2) cap <<= 1;
  return cap;
}

template <typename T>
inline void store_at(uint8_t* base, int64_t idx, T v) {
  std::memcpy(base + idx * int64_t(sizeof(T)), &v, sizeof(T));
}
template <typename T>
inline T load_at(const uint8_t* base, int64_t idx) {
  T v;
  std::memcpy(&v, base + idx * int64_t(sizeof(T)), sizeof(T));
  return v;
}

// Batched append core.  The per-record interleaved form (decode one
// record, probe the dedupe table, RMW the extreme tables, repeat) stalls
// on a dependent random cache miss per record; the passes below keep the
// chained packer's memory-level parallelism — decode writes the
// per-record sections in one tight loop while stashing the reduction
// inputs compactly, then dedupe/HLL/extremes each run as a dedicated
// tight pass per frame.

// Compact per-frame stash of the reduction inputs, carved out of the
// caller scratch after the dedupe table: hashes + aliveness for ACTIVE
// (non-null key) records, and — wire v5 with quantiles — the message
// sizes of SIZED (non-tombstone) records for the DDSketch bucket pass.
struct FrameStash {
  uint64_t* h64;
  uint32_t* h32;
  int64_t* size;
  uint8_t* alive;
  int64_t n;    // active records stashed (h64/h32/alive)
  int64_t nsz;  // sized records stashed (size)
};

inline FrameStash stash_of(int64_t* scr, int64_t b, int64_t cap_alloc) {
  // cap_alloc is the ALLOCATED table capacity (pack_scratch_cap), not
  // scr[2]: the active capacity starts small and grows, but the stash
  // lives past the full allocation.  Region order keeps every 8-byte
  // field 8-aligned for any b (base is int64-aligned; 8b and 16b are
  // multiples of 8).
  FrameStash s;
  uint8_t* base = reinterpret_cast<uint8_t*>(scr + 3 + cap_alloc);
  s.h64 = reinterpret_cast<uint64_t*>(base);
  s.size = reinterpret_cast<int64_t*>(base + 8 * b);
  s.h32 = reinterpret_cast<uint32_t*>(base + 16 * b);
  s.alive = base + 20 * b;
  s.n = 0;
  s.nsz = 0;
  return s;
}

inline int64_t pack_stash_len64(int64_t b, int32_t with_alive,
                                int32_t with_hll, int32_t q_rows) {
  if (!with_alive && with_hll != 2 && q_rows <= 0) return 0;
  return (21 * b + 7) / 8;
}

// Compacted-pair emission region (with_alive == 2): slots u32[b] + flags
// u8[b] carved out of the caller scratch PAST the full (unconditional)
// stash, so Python locates it as kta_pack_scratch_len(b, 1, bits) int64
// elements in — independent of which stash sections the config uses.
inline int64_t pairs_off64(int64_t b, int32_t alive_bits) {
  return 3 + pack_scratch_cap(b, 1, alive_bits) +
         pack_stash_len64(b, 1, 2, 1);
}

inline int64_t pairs_len64(int64_t b) { return (5 * b + 7) / 8; }

inline void attach_scratch_pairs(PackRowLayout* r, int64_t* scratch) {
  if (r->with_alive != 2) return;
  uint8_t* pb =
      reinterpret_cast<uint8_t*>(scratch + pairs_off64(r->b, r->alive_bits));
  r->slot32 = pb;
  r->alive8 = pb + 4 * r->b;
}

// Grow the active dedupe table (doubling, bounded by the allocated max)
// once the load factor reaches 1/2, re-inserting the existing pairs from
// the row's slot section.  Capacity and rehashing change probe POSITIONS
// only — pair output order stays first-occurrence record order — so rows
// remain byte-identical to kta_dedupe_slots while a low-cardinality
// batch keeps its table cache-resident instead of paying the worst-case
// 2·batch_size table from the first record.
inline void dedupe_maybe_grow(const PackRowLayout& r, int64_t* scr,
                              int64_t cap_max) {
  int64_t cap = scr[2];
  if (cap >= cap_max || scr[1] * 2 < cap) return;
  while (cap < cap_max && scr[1] * 2 >= cap) cap <<= 1;
  int64_t* table = scr + 3;
  std::memset(table, 0, size_t(cap) * 8);
  const int64_t cap_mask = cap - 1;
  for (int64_t j = 0; j < scr[1]; ++j) {
    const uint32_t slot = load_at<uint32_t>(r.slot32, j);
    int64_t pos = int64_t(splitmix64(slot) & uint64_t(cap_mask));
    while (table[pos] != 0) pos = (pos + 1) & cap_mask;
    table[pos] = j + 1;
  }
  scr[2] = cap;
}

// Dedicated LWW dedupe pass: insert the stash's (slot, alive) pairs into
// the row's persistent open-addressing table — same algorithm (and same
// first-occurrence output order) as kta_dedupe_slots, but incremental
// across appends because the table lives in the caller scratch.
inline void dedupe_pass(const PackRowLayout& r, int64_t* scr,
                        const uint32_t* h32, const uint8_t* alive,
                        int64_t n) {
  const uint32_t mask =
      r.alive_bits == 32 ? 0xffffffffu : ((1u << r.alive_bits) - 1u);
  const int64_t cap_max = pack_scratch_cap(r.b, 1, r.alive_bits);
  int64_t* table = scr + 3;
  int64_t np = scr[1];
  for (int64_t j = 0; j < n; ++j) {
    scr[1] = np;
    dedupe_maybe_grow(r, scr, cap_max);
    const int64_t cap_mask = scr[2] - 1;
    const uint32_t slot = h32[j] & mask;
    int64_t pos = int64_t(splitmix64(slot) & uint64_t(cap_mask));
    for (;;) {
      const int64_t entry = table[pos];
      if (entry == 0) {
        table[pos] = np + 1;
        store_at<uint32_t>(r.slot32, np, slot);
        r.alive8[np] = alive[j];
        ++np;
        break;
      }
      if (load_at<uint32_t>(r.slot32, entry - 1) == slot) {
        r.alive8[entry - 1] = alive[j];  // later record wins
        break;
      }
      pos = (pos + 1) & cap_mask;
    }
  }
  scr[1] = np;
}

// Dedicated HLL register-table pass (mode 2) over the stash's h64 values.
inline void hll_table_pass(const PackRowLayout& r, int32_t dense_p,
                           const uint64_t* h64, int64_t n) {
  const int64_t row = r.hll_rows > 1 ? dense_p : 0;
  uint8_t* tbl = r.hll_a;
  for (int64_t j = 0; j < n; ++j) {
    const uint64_t h = splitmix64(h64[j]);
    const int64_t idx = (row << r.hll_p) | int64_t(h >> (64 - r.hll_p));
    const uint64_t rest = h << r.hll_p;
    const uint8_t rho =
        rest == 0 ? static_cast<uint8_t>(64 - r.hll_p + 1)
                  : static_cast<uint8_t>(__builtin_clzll(rest) + 1);
    if (rho > tbl[idx]) tbl[idx] = rho;
  }
}

// Wire v5: fold one single-partition frame's counter registers into the
// row's i64[P, 7] delta table — ONE 7-entry RMW per frame/append, the
// combiner's whole per-frame cost for the channels that used to ship as
// four per-record columns.  Channel order = results.COUNTER_CHANNELS.
inline void commit_counts(const PackRowLayout& r, int32_t dense_p,
                          int64_t total, int64_t tomb, int64_t knull,
                          int64_t ksum, int64_t vsum) {
  const int64_t base = int64_t(dense_p) * 7;
  const int64_t vals[7] = {total,         tomb,  total - tomb, knull,
                           total - knull, ksum,  vsum};
  for (int c = 0; c < 7; ++c)
    store_at<int64_t>(r.cnt64, base + c,
                      load_at<int64_t>(r.cnt64, base + c) + vals[c]);
}

// Wire v5 DDSketch pass: bucket the stashed message sizes through the
// shared integer edge table (ops/ddsketch.py::ddsketch_edges — binary
// search == numpy searchsorted side='left') into the row's per-row
// bucket-count table.  Runs after the frame parses, like every reduction.
inline void quant_pass(const PackRowLayout& r, int32_t dense_p,
                       const int64_t* sizes, int64_t n) {
  const int64_t nb = int64_t(r.q_nbuckets) + 2;
  const int64_t base = (r.q_rows > 1 ? int64_t(dense_p) : 0) * nb;
  for (int64_t j = 0; j < n; ++j) {
    const int64_t s = sizes[j];
    int64_t idx = 0;
    if (s != 0)
      idx = (std::lower_bound(r.q_edges, r.q_edges + r.q_nbuckets, s) -
             r.q_edges) + 1;
    store_at<int64_t>(r.q64, base + idx,
                      load_at<int64_t>(r.q64, base + idx) + 1);
  }
}

// One table RMW per frame/append instead of four per record.
inline void commit_extremes(const PackRowLayout& r, int32_t dense_p,
                            int64_t ts_min, int64_t ts_max, int64_t sz_min,
                            int64_t sz_max, bool any_ts, bool any_sz) {
  if (any_ts) {
    if (ts_min < load_at<int64_t>(r.tsmm, dense_p))
      store_at<int64_t>(r.tsmm, dense_p, ts_min);
    if (ts_max > load_at<int64_t>(r.tsmm, r.P + dense_p))
      store_at<int64_t>(r.tsmm, r.P + dense_p, ts_max);
  }
  if (any_sz) {
    if (sz_min < load_at<int64_t>(r.szmm, dense_p))
      store_at<int64_t>(r.szmm, dense_p, sz_min);
    if (sz_max > load_at<int64_t>(r.szmm, r.P + dense_p))
      store_at<int64_t>(r.szmm, r.P + dense_p, sz_max);
  }
}

// Rewind a failed frame's partial appends: reset the cursor and re-zero
// the per-record section spans it touched, so the row stays byte-
// identical to one that never saw the frame (the reductions were not
// committed — they only run after a frame parses completely).
inline void rewind_appends(const PackRowLayout& r, int64_t* scr,
                           int64_t cursor0) {
  const int64_t n = scr[0];
  if (n <= cursor0) return;
  const int64_t c = n - cursor0;
  if (!r.wire_v5) {
    // v5 has no per-record column sections — its counter/quantile
    // reductions only commit after the frame parses, so the cursor reset
    // below is the whole rewind for them.
    std::memset(r.p16 + 2 * cursor0, 0, size_t(2 * c));
    std::memset(r.kl16 + 2 * cursor0, 0, size_t(2 * c));
    std::memset(r.vl32 + 4 * cursor0, 0, size_t(4 * c));
    std::memset(r.fl8 + cursor0, 0, size_t(c));
  }
  if (r.with_hll == 1) {
    std::memset(r.hll_a + 2 * cursor0, 0, size_t(2 * c));
    std::memset(r.hll_b + cursor0, 0, size_t(c));
  } else if (r.with_hll == 3) {
    std::memset(r.hll_a + 4 * cursor0, 0, size_t(4 * c));
    std::memset(r.hll_b + cursor0, 0, size_t(c));
  }
  scr[0] = cursor0;
}

// Store-free validation of one v2 frame's records: every record must parse
// inside its bounds, and every record IN the acceptance window must fit
// the wire-v4 ranges, so the append pass can never fail mid-frame.
// (Out-of-window records are never packed — the chained path filters them
// before pack_batch ever sees them, so a range violation there must not
// abort the fused scan either.)  Returns 0 ok, 1 malformed (caller stops
// the walk at this frame for the Python chain to classify), 2 pack-range
// violation (detail filled; the whole call errors like the numpy packer
// would).
inline int validate_frame_records(const uint8_t* payload, int64_t plen,
                                  int32_t nrec, int32_t vcap,
                                  int64_t base_offset, int64_t min_off,
                                  int64_t max_off, int64_t* detail) {
  int64_t pos = 0;
  for (int32_t i = 0; i < nrec; ++i) {
    int64_t length;
    if (!read_zigzag(payload, plen, pos, length)) return 1;
    if (length < 0 || length > plen - pos) return 1;
    const int64_t rec_end = pos + length;
    if (pos >= rec_end) return 1;
    ++pos;  // attributes
    int64_t ts_delta, off_delta, klen, vlen;
    if (!read_zigzag(payload, rec_end, pos, ts_delta)) return 1;
    if (!read_zigzag(payload, rec_end, pos, off_delta)) return 1;
    if (!read_zigzag(payload, rec_end, pos, klen)) return 1;
    if (klen >= 0) {
      if (klen > rec_end - pos || klen > 0x7fffffff) return 1;
      pos += klen;
    }
    if (!read_zigzag(payload, rec_end, pos, vlen)) return 1;
    if (vlen >= 0) {
      if (vlen > rec_end - pos || vlen > 0x7fffffff) return 1;
      pos += vlen;
    }
    const int64_t off = base_offset + off_delta;
    if (off >= min_off && off < max_off) {
      if (klen > 0xffff) {
        detail[0] = 0;
        detail[1] = klen;
        return 2;
      }
      if (vlen > vcap) {
        detail[0] = 1;
        detail[1] = vlen;
        return 2;
      }
    }
    int64_t nheaders;
    if (!read_zigzag(payload, rec_end, pos, nheaders)) return 1;
    if (nheaders < 0) return 1;
    for (int64_t h = 0; h < nheaders; ++h) {
      int64_t hk, hv;
      if (!read_zigzag(payload, rec_end, pos, hk)) return 1;
      if (hk < 0 || hk > rec_end - pos) return 1;
      pos += hk;
      if (!read_zigzag(payload, rec_end, pos, hv)) return 1;
      if (hv > 0) {
        if (hv > rec_end - pos) return 1;
        pos += hv;
      }
    }
    pos = rec_end;
  }
  return 0;
}

// Wire-v5 full-batch packer (the chained path's combiner form): one
// sequential pass folds the SoA columns into the per-partition tables —
// counter deltas, ts/size extremes, DDSketch buckets — with the same
// validation kta_pack_batch's v4 branch applies.  Multi-partition batches
// are fine here (unlike the fused single-partition appends): every table
// indexes by the record's own partition.
int64_t pack_batch_v5(
    const int32_t* partition, const int32_t* key_len, const int32_t* value_len,
    const uint8_t* key_null, const uint8_t* value_null, const int64_t* ts_s,
    const uint32_t* h32, const uint64_t* h64,
    int64_t n_valid, int64_t batch_size, int32_t num_partitions,
    int32_t with_alive, int32_t alive_bits, int32_t with_hll, int32_t hll_p,
    int32_t hll_rows, int32_t value_len_cap, int32_t q_rows,
    int32_t q_nbuckets, const int64_t* q_edges, uint8_t* out,
    int64_t out_cap) {
  PackRowLayout r;
  if (!pack_row_layout(out, out_cap, batch_size, num_partitions, with_alive,
                       alive_bits, with_hll, hll_p, hll_rows, value_len_cap,
                       1, q_rows, q_nbuckets, q_edges, &r))
    return -1;
  const int64_t P = num_partitions;
  std::memset(out, 0, r.need);

  std::vector<int64_t> cnt(size_t(P) * 7, 0);
  std::vector<int64_t> mm(2 * P), sz(2 * P);
  for (int64_t p = 0; p < P; ++p) {
    mm[p] = INT64_MAX;
    mm[P + p] = INT64_MIN;
    sz[p] = INT64_MAX;
    sz[P + p] = 0;
  }
  const int64_t nb = int64_t(q_nbuckets) + 2;
  std::vector<int64_t> qt(
      q_rows > 0 ? size_t(q_rows) * size_t(nb) : size_t(0), 0);
  for (int64_t i = 0; i < n_valid; ++i) {
    const int32_t p = partition[i];
    if (p < 0 || p > 0x7fff || p >= num_partitions ||
        key_len[i] < 0 || key_len[i] > 0xffff ||
        value_len[i] < 0 || value_len[i] > r.vcap)
      return -1;
    const bool kn = !key_null[i];
    const bool vn = !value_null[i];
    int64_t* row = cnt.data() + int64_t(p) * 7;
    row[0] += 1;
    row[1] += vn ? 0 : 1;
    row[2] += vn ? 1 : 0;
    row[3] += kn ? 0 : 1;
    row[4] += kn ? 1 : 0;
    if (kn) row[5] += key_len[i];
    if (vn) row[6] += value_len[i];
    const int64_t t = ts_s[i];
    if (t < mm[p]) mm[p] = t;
    if (t > mm[P + p]) mm[P + p] = t;
    if (vn) {
      const int64_t size =
          (kn ? int64_t(key_len[i]) : 0) + int64_t(value_len[i]);
      if (size < sz[p]) sz[p] = size;
      if (size > sz[P + p]) sz[P + p] = size;
      if (q_rows > 0) {
        int64_t idx = 0;
        if (size != 0)
          idx = (std::lower_bound(q_edges, q_edges + q_nbuckets, size) -
                 q_edges) + 1;
        qt[size_t((q_rows > 1 ? int64_t(p) : 0) * nb + idx)] += 1;
      }
    }
  }
  std::memcpy(r.cnt64, cnt.data(), size_t(P) * 7 * 8);
  std::memcpy(r.tsmm, mm.data(), size_t(2 * P) * 8);
  std::memcpy(r.szmm, sz.data(), size_t(2 * P) * 8);
  if (q_rows > 0) std::memcpy(r.q64, qt.data(), qt.size() * 8);

  int64_t n_pairs = 0;
  if (with_alive && n_valid > 0) {
    // Same pre-reduction as the v4 branch: LWW dedupe into aligned
    // temporaries, then memcpy into the (possibly unaligned) section.
    std::vector<uint8_t> active(n_valid), alive(n_valid);
    for (int64_t i = 0; i < n_valid; ++i) {
      active[i] = key_null[i] ? 0 : 1;
      alive[i] = value_null[i] ? 0 : 1;
    }
    std::vector<uint32_t> slots(n_valid);
    std::vector<uint8_t> flags(n_valid);
    n_pairs = kta_dedupe_slots(h32, active.data(), alive.data(), n_valid,
                               alive_bits, slots.data(), flags.data());
    if (n_pairs < 0) return -1;
    std::memcpy(r.slot32, slots.data(), size_t(n_pairs) * 4);
    std::memcpy(r.alive8, flags.data(), size_t(n_pairs));
  }
  if (with_hll == 1 || with_hll == 3) {
    for (int64_t i = 0; i < n_valid; ++i) {
      if (key_null[i]) {
        if (with_hll == 1)
          store_at<uint16_t>(r.hll_a, i, 0);
        else
          store_at<uint32_t>(r.hll_a, i, 0);
        r.hll_b[i] = 0;
        continue;
      }
      const uint64_t h = splitmix64(h64[i]);
      const uint32_t bucket = static_cast<uint32_t>(h >> (64 - hll_p));
      if (with_hll == 1)
        store_at<uint16_t>(r.hll_a, i, static_cast<uint16_t>(bucket));
      else
        store_at<uint32_t>(
            r.hll_a, i,
            (static_cast<uint32_t>(partition[i]) << hll_p) | bucket);
      const uint64_t rest = h << hll_p;
      r.hll_b[i] = rest == 0
                       ? static_cast<uint8_t>(64 - hll_p + 1)
                       : static_cast<uint8_t>(__builtin_clzll(rest) + 1);
    }
  } else if (with_hll == 2) {
    uint8_t* tbl = r.hll_a;
    const bool per_row = hll_rows > 1;
    for (int64_t i = 0; i < n_valid; ++i) {
      if (key_null[i]) continue;
      const uint64_t h = splitmix64(h64[i]);
      const int64_t row = per_row ? partition[i] : 0;
      const int64_t idx = (row << hll_p) | int64_t(h >> (64 - hll_p));
      const uint64_t rest = h << hll_p;
      const uint8_t rho =
          rest == 0 ? static_cast<uint8_t>(64 - hll_p + 1)
                    : static_cast<uint8_t>(__builtin_clzll(rest) + 1);
      if (rho > tbl[idx]) tbl[idx] = rho;
    }
  }

  const int32_t hv = static_cast<int32_t>(n_valid);
  const int32_t hp = static_cast<int32_t>(n_pairs);
  std::memcpy(out, &hv, 4);
  std::memcpy(out + 4, &hp, 4);
  return r.need;
}

}  // namespace

extern "C" {

// Scratch length (int64 elements) a pack row needs: counters + the
// persistent dedupe table + the per-frame reduction stash.
int64_t kta_pack_scratch_len(int64_t batch_size, int32_t with_alive,
                             int32_t alive_bits) {
  if (batch_size < 0) return -1;
  // The stash region is sized unconditionally (it also serves HLL table
  // mode with alive off, and wire v5's size stash) — a few MB at worst,
  // allocated once per sink.  with_alive == 2 (pair compaction) appends
  // the pair emission region; its offset is exactly the with_alive == 1
  // return value, which is how the Python side locates it.
  int64_t n = 3 + pack_scratch_cap(batch_size, with_alive, alive_bits) +
              pack_stash_len64(batch_size, 1, 2, 1);
  if (with_alive == 2) n += pairs_len64(batch_size);
  return n;
}

// Initialize one wire row (v4 or v5) for incremental appends: zero the
// buffer, identity-fill the extreme tables, reset the scratch.  An
// initialized, never-appended row is byte-identical to a packed EMPTY
// batch (the superbatch identity pad), so partial-row padding is just
// init — under v5 the zeroed counter/quantile tables ARE the fold
// identity.  Returns the row's total bytes (== packing.packed_nbytes)
// or -1.
int64_t kta_pack_row_init(uint8_t* out, int64_t out_cap, int64_t* scratch,
                          int64_t scratch_len, int64_t batch_size,
                          int32_t num_partitions, int32_t with_alive,
                          int32_t alive_bits, int32_t with_hll,
                          int32_t hll_p, int32_t hll_rows,
                          int32_t value_len_cap, int32_t wire_v5,
                          int32_t q_rows, int32_t q_nbuckets,
                          const int64_t* q_edges) {
  PackRowLayout r;
  if (!scratch ||
      !pack_row_layout(out, out_cap, batch_size, num_partitions, with_alive,
                       alive_bits, with_hll, hll_p, hll_rows, value_len_cap,
                       wire_v5, q_rows, q_nbuckets, q_edges, &r))
    return -1;
  const int64_t cap = pack_scratch_cap(batch_size, with_alive, alive_bits);
  if (scratch_len < 3 + cap + pack_stash_len64(batch_size, with_alive,
                                               with_hll, q_rows))
    return -1;
  if (with_alive == 2 &&
      scratch_len < pairs_off64(batch_size, alive_bits) +
                        pairs_len64(batch_size))
    return -1;
  attach_scratch_pairs(&r, scratch);
  std::memset(out, 0, r.need);
  for (int64_t p = 0; p < r.P; ++p) {
    store_at<int64_t>(r.tsmm, p, INT64_MAX);
    store_at<int64_t>(r.tsmm, r.P + p, INT64_MIN);
    store_at<int64_t>(r.szmm, p, INT64_MAX);
    store_at<int64_t>(r.szmm, r.P + p, 0);
  }
  scratch[0] = 0;
  scratch[1] = 0;
  // Active table capacity starts small and grows with distinct slots
  // (dedupe_maybe_grow) — low-cardinality rows keep it cache-resident.
  scratch[2] = cap < 4096 ? cap : 4096;
  std::memset(scratch + 3, 0, size_t(scratch[2]) * 8);
  return r.need;
}

// Compacted alive-pair MASK build (packing.alive_table_mode == 2): apply
// the raw (slot, flag) pair stream — concatenated per-dispatch batches,
// STREAM ORDER, duplicates allowed — last-writer-wins straight into
// set/clear word masks: a set pair turns its bit on in set and off in
// clear, a tombstone pair the reverse, so the masks ARE the compacted
// LWW monoid value and the device merge is one elementwise
// (words & ~clear) | set pass (no scatter).  Both masks are zeroed here.
// Returns the number of DISTINCT touched slots (the emitted-pairs
// telemetry), or -1 on bad arguments.
int64_t kta_pairs_to_masks(const uint32_t* slots, const uint8_t* flags,
                           int64_t n, int32_t bits, uint32_t* set_out,
                           uint32_t* clear_out) {
  if (!set_out || !clear_out || n < 0 || bits < 1 || bits > 32) return -1;
  if (n > 0 && (!slots || !flags)) return -1;
  const int64_t W = int64_t(1) << (bits > 5 ? bits - 5 : 0);
  std::memset(set_out, 0, size_t(W) * 4);
  std::memset(clear_out, 0, size_t(W) * 4);
  int64_t touched = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t s = slots[i];
    const int64_t w = s >> 5;
    const uint32_t bit = 1u << (s & 31);
    if (w >= W) return -1;  // slot past the declared bitmap width
    if (!((set_out[w] | clear_out[w]) & bit)) ++touched;
    if (flags[i]) {
      set_out[w] |= bit;
      clear_out[w] &= ~bit;
    } else {
      clear_out[w] |= bit;
      set_out[w] &= ~bit;
    }
  }
  return touched;
}

// Fused decode→pack over a record set's native-decodable prefix, starting
// at byte `start_pos` (0, or a previous call's resume position).  Records
// with min_off <= offset < max_off append to the row; the walk stops at
// the first non-native frame (compressed / legacy / truncated / malformed
// — Python chain takes over from `consumed`) or when the row fills
// mid-frame (st[5] = 1; resume with start_pos = st[0], skip = st[4] after
// rotating rows).  Frame atomicity: a frame that might span the row
// boundary is pre-validated store-free; any other frame that turns out
// malformed mid-parse has its partial appends rewound (reductions only
// commit after a frame parses completely) — either way a frame appends
// all of its in-range records or none.  st is int64[8]:
//   in:  st[4] = records of the frame at start_pos already processed
//   out: st[0] consumed (bytes of fully-processed frames)
//        st[1] covered_end (max base+last_offset_delta+1; -1 none)
//        st[2] last appended offset (-1 none this call)
//        st[3] last appended ts_s
//        st[4] resume skip count   st[5] row-full flag
//        st[6]/st[7] pack-range error detail (rc == -2)
// Returns records appended this call, -1 bad args, -2 pack-range.
int64_t kta_decode_pack_record_set(
    const uint8_t* buf, int64_t len, int32_t verify_crc, int64_t start_pos,
    int64_t min_off, int64_t max_off, int32_t dense_partition,
    int64_t batch_size, int32_t num_partitions, int32_t with_alive,
    int32_t alive_bits, int32_t with_hll, int32_t hll_p, int32_t hll_rows,
    int32_t value_len_cap, int32_t wire_v5, int32_t q_rows,
    int32_t q_nbuckets, const int64_t* q_edges, uint8_t* out,
    int64_t out_cap, int64_t* scratch, int64_t* st) {
  PackRowLayout r;
  if (!buf || len < 0 || !st || !scratch || start_pos < 0 ||
      start_pos > len || dense_partition < 0 ||
      dense_partition >= num_partitions ||
      !pack_row_layout(out, out_cap, batch_size, num_partitions, with_alive,
                       alive_bits, with_hll, hll_p, hll_rows, value_len_cap,
                       wire_v5, q_rows, q_nbuckets, q_edges, &r))
    return -1;
  attach_scratch_pairs(&r, scratch);
  const bool need_stash = with_alive || with_hll == 2;
  FrameStash stash = stash_of(
      scratch, r.b, pack_scratch_cap(r.b, with_alive, alive_bits));
  int64_t skip = st[4];
  int64_t pos = start_pos, covered = -1, appended = 0;
  int64_t last_off = -1, last_ts = 0;
  st[5] = 0;
  FrameHeader fh;
  while (native_frame_at(buf, len, pos, verify_crc, &fh)) {
    if (fh.control) {
      if (fh.covered_end > covered) covered = fh.covered_end;
      pos = fh.end;
      skip = 0;
      continue;
    }
    const uint8_t* payload = buf + fh.payload_pos;
    const int64_t plen = fh.end - fh.payload_pos;
    const int64_t space = r.b - scratch[0];
    if (fh.num_records - skip > space) {
      // This frame may outlive the current row: pre-validate it store-
      // free so a malformation found AFTER the row rotates can never
      // leave a committed partial frame behind.  Boundary-only cost —
      // at most one frame per row takes this double walk.
      const int v = validate_frame_records(payload, plen, fh.num_records,
                                           r.vcap, fh.base_offset, min_off,
                                           max_off, st + 6);
      if (v == 2) return -2;
      if (v != 0) break;
    }
    // Decode pass: tight per-record parse + section stores at the
    // cursor, reduction inputs stashed compactly; dedupe/HLL/extreme
    // commits run as dedicated passes after the frame parses.
    const int64_t cursor0 = scratch[0];
    stash.n = 0;
    stash.nsz = 0;
    int64_t ts_min = INT64_MAX, ts_max = INT64_MIN;
    int64_t sz_min = INT64_MAX, sz_max = 0;
    // Wire v5: per-frame counter registers (single-partition frames fold
    // to ONE 7-entry table commit — commit_counts).
    int64_t f_tomb = 0, f_knull = 0, f_ksum = 0, f_vsum = 0;
    int64_t f_last_off = -1, f_last_ts = 0, f_appended = 0;
    int64_t rpos = 0;
    int32_t i = 0;
    bool full = false, malformed = false;
    for (; i < fh.num_records; ++i) {
      int64_t length = 0, ts_delta = 0, off_delta = 0, klen = 0, vlen = 0;
      if (!read_zigzag(payload, plen, rpos, length) || length < 0 ||
          length > plen - rpos) {
        malformed = true;
        break;
      }
      const int64_t rec_end = rpos + length;
      if (rpos >= rec_end) {
        malformed = true;
        break;
      }
      ++rpos;  // attributes
      if (!read_zigzag(payload, rec_end, rpos, ts_delta) ||
          !read_zigzag(payload, rec_end, rpos, off_delta) ||
          !read_zigzag(payload, rec_end, rpos, klen)) {
        malformed = true;
        break;
      }
      const uint8_t* kp = payload + rpos;
      if (klen >= 0) {
        if (klen > rec_end - rpos || klen > 0x7fffffff) {
          malformed = true;
          break;
        }
        rpos += klen;
      }
      if (!read_zigzag(payload, rec_end, rpos, vlen)) {
        malformed = true;
        break;
      }
      if (vlen >= 0) {
        if (vlen > rec_end - rpos || vlen > 0x7fffffff) {
          malformed = true;
          break;
        }
        rpos += vlen;
      }
      int64_t nheaders = 0;
      if (!read_zigzag(payload, rec_end, rpos, nheaders) || nheaders < 0) {
        malformed = true;
        break;
      }
      for (int64_t h = 0; h < nheaders; ++h) {
        int64_t hk = 0, hv = 0;
        if (!read_zigzag(payload, rec_end, rpos, hk) || hk < 0 ||
            hk > rec_end - rpos) {
          malformed = true;
          break;
        }
        rpos += hk;
        if (!read_zigzag(payload, rec_end, rpos, hv)) {
          malformed = true;
          break;
        }
        if (hv > 0) {
          if (hv > rec_end - rpos) {
            malformed = true;
            break;
          }
          rpos += hv;
        }
      }
      if (malformed) break;
      rpos = rec_end;  // tolerate unknown trailing record fields
      if (i < skip) continue;  // already appended into a previous row
      const int64_t off = fh.base_offset + off_delta;
      if (off < min_off || off >= max_off) continue;
      // Pack-range checks only for records the scan ACCEPTS — the
      // chained path filters out-of-window records before pack_batch
      // ever sees them, so an oversized record past the watermark must
      // not abort the fused scan either.
      if (klen > 0xffff) {
        rewind_appends(r, scratch, cursor0);
        st[6] = 0;
        st[7] = klen;
        return -2;
      }
      if (vlen > r.vcap) {
        rewind_appends(r, scratch, cursor0);
        st[6] = 1;
        st[7] = vlen;
        return -2;
      }
      if (scratch[0] >= r.b) {
        full = true;
        break;
      }
      const bool key_null = klen < 0;
      const bool value_null = vlen < 0;
      const int64_t n = scratch[0];
      if (r.wire_v5) {
        // Combiner rows: no per-record columns — accumulate the frame's
        // counter registers instead (committed once per frame below).
        if (value_null) ++f_tomb;
        if (key_null) ++f_knull;
        if (!key_null) f_ksum += klen;
        if (!value_null) f_vsum += vlen;
      } else {
        store_at<int16_t>(r.p16, n, static_cast<int16_t>(dense_partition));
        store_at<uint16_t>(r.kl16, n,
                           static_cast<uint16_t>(key_null ? 0 : klen));
        store_at<uint32_t>(r.vl32, n,
                           static_cast<uint32_t>(value_null ? 0 : vlen));
        r.fl8[n] = (key_null ? 1 : 0) | (value_null ? 2 : 0);
      }
      const int64_t ts_ms = fh.first_ts + ts_delta;
      const int64_t ts_s = ts_ms < 0 ? 0 : ts_ms / 1000;
      if (ts_s < ts_min) ts_min = ts_s;
      if (ts_s > ts_max) ts_max = ts_s;
      if (!value_null) {
        const int64_t size = (key_null ? 0 : klen) + vlen;
        if (size < sz_min) sz_min = size;
        if (size > sz_max) sz_max = size;
        if (r.q64) stash.size[stash.nsz++] = size;
      }
      uint32_t h32 = 0;
      uint64_t h64 = 0;
      if (!key_null) {
        fnv1a_both(kp, klen, &h32, &h64);
        if (need_stash) {
          stash.h32[stash.n] = h32;
          stash.h64[stash.n] = h64;
          stash.alive[stash.n] = value_null ? 0 : 1;
          ++stash.n;
        }
      }
      if (r.with_hll == 1 || r.with_hll == 3) {
        if (key_null) {
          if (r.with_hll == 1)
            store_at<uint16_t>(r.hll_a, n, 0);
          else
            store_at<uint32_t>(r.hll_a, n, 0);
          r.hll_b[n] = 0;
        } else {
          const uint64_t h = splitmix64(h64);
          const uint32_t bucket =
              static_cast<uint32_t>(h >> (64 - r.hll_p));
          if (r.with_hll == 1)
            store_at<uint16_t>(r.hll_a, n, static_cast<uint16_t>(bucket));
          else
            // v5 flat pairs: the register row rides inside the index.
            store_at<uint32_t>(
                r.hll_a, n,
                (static_cast<uint32_t>(dense_partition) << r.hll_p) | bucket);
          const uint64_t rest = h << r.hll_p;
          r.hll_b[n] =
              rest == 0 ? static_cast<uint8_t>(64 - r.hll_p + 1)
                        : static_cast<uint8_t>(__builtin_clzll(rest) + 1);
        }
      }
      scratch[0] = n + 1;
      ++f_appended;
      f_last_off = off;
      f_last_ts = ts_s;
    }
    if (malformed) {
      // A spanning frame was pre-validated, so this is a non-spanning
      // frame's first touch: rewind its partial appends and hand the
      // frame to the Python chain for the precise classification.
      rewind_appends(r, scratch, cursor0);
      break;
    }
    // Commit the frame's (possibly partial, on row-full) reductions —
    // these records stay in this row either way.
    if (f_appended) {
      commit_extremes(r, dense_partition, ts_min, ts_max, sz_min, sz_max,
                      true, sz_min != INT64_MAX || sz_max != 0);
      if (with_alive) dedupe_pass(r, scratch, stash.h32, stash.alive,
                                  stash.n);
      if (r.with_hll == 2) hll_table_pass(r, dense_partition, stash.h64,
                                          stash.n);
      if (r.wire_v5) {
        commit_counts(r, dense_partition, f_appended, f_tomb, f_knull,
                      f_ksum, f_vsum);
        if (r.q64) quant_pass(r, dense_partition, stash.size, stash.nsz);
      }
      appended += f_appended;
      last_off = f_last_off;
      last_ts = f_last_ts;
    }
    if (full) {
      st[4] = i;  // resume: skip the records already processed
      st[5] = 1;
      break;
    }
    if (fh.covered_end > covered) covered = fh.covered_end;
    pos = fh.end;
    skip = 0;
  }
  st[0] = pos;
  st[1] = covered;
  st[2] = last_off;
  st[3] = last_ts;
  if (!st[5]) st[4] = 0;
  // Live header: the row is a valid packed batch after every call.
  // Under pair compaction the row has no pair sections — its header says
  // n_pairs 0 (the pairs ride the dispatch-level merged table instead).
  const int32_t hv = static_cast<int32_t>(scratch[0]);
  const int32_t hp =
      with_alive == 2 ? 0 : static_cast<int32_t>(scratch[1]);
  std::memcpy(out, &hv, 4);
  std::memcpy(out + 4, &hp, 4);
  return appended;
}

// Column-append fallback half of the fused path: records [start, n) — n
// is the exclusive END INDEX into the columns, not a count —
// of already-decoded SoA columns (a salvaged frame, a segment chunk's
// memmap views) append into the row through the SAME batched passes, so
// fused rows mixing decoded and fallback records stay byte-identical to
// the chained pack.  All records belong to ONE (dense) partition.
// ts semantics: ts_mode = 0 takes ts[] as seconds verbatim; 1 floor-
// divides milliseconds by 1000 (the segment reader's rule); 2 clamps
// negatives to 0 then divides (the wire decoder's rule).
// Returns records appended (stops at row capacity), -1 bad args, -2
// pack-range violation (detail[0] field / detail[1] value).
int64_t kta_pack_append_columns(
    uint8_t* out, int64_t out_cap, int64_t* scratch, int32_t dense_partition,
    const int32_t* key_len, const int32_t* value_len, const uint8_t* key_null,
    const uint8_t* value_null, const int64_t* ts, int32_t ts_mode,
    const uint32_t* h32, const uint64_t* h64, int64_t start, int64_t n,
    int64_t batch_size, int32_t num_partitions, int32_t with_alive,
    int32_t alive_bits, int32_t with_hll, int32_t hll_p, int32_t hll_rows,
    int32_t value_len_cap, int32_t wire_v5, int32_t q_rows,
    int32_t q_nbuckets, const int64_t* q_edges, int64_t* detail) {
  PackRowLayout r;
  if (!key_len || !value_len || !key_null || !value_null || !ts || !h32 ||
      !h64 || !scratch || !detail || start < 0 || n < 0 || start > n ||
      dense_partition < 0 || dense_partition >= num_partitions ||
      dense_partition > 0x7fff || ts_mode < 0 || ts_mode > 2 ||
      !pack_row_layout(out, out_cap, batch_size, num_partitions, with_alive,
                       alive_bits, with_hll, hll_p, hll_rows, value_len_cap,
                       wire_v5, q_rows, q_nbuckets, q_edges, &r))
    return -1;
  attach_scratch_pairs(&r, scratch);
  int64_t take = n - start;
  const int64_t space = r.b - scratch[0];
  if (space < 0) return -1;
  if (take > space) take = space;
  const int64_t lo = start, hi = start + take;
  // Validate before any append — same atomicity rule as the decode path,
  // and the same UNCONDITIONAL column checks as kta_pack_batch (range
  // violations reject even on null-key/tombstone records).
  for (int64_t i = lo; i < hi; ++i) {
    if (key_len[i] < 0 || key_len[i] > 0xffff) {
      detail[0] = 0;
      detail[1] = key_len[i];
      return -2;
    }
    if (value_len[i] < 0 || value_len[i] > r.vcap) {
      detail[0] = 1;
      detail[1] = value_len[i];
      return -2;
    }
  }
  const int64_t c0 = scratch[0];
  if (r.wire_v5) {
    // Combiner rows: fold the columns straight into the frame registers
    // (one commit_counts below) — no per-record column sections exist.
    int64_t f_tomb = 0, f_knull = 0, f_ksum = 0, f_vsum = 0;
    for (int64_t i = lo; i < hi; ++i) {
      if (value_null[i]) ++f_tomb;
      if (key_null[i]) ++f_knull;
      if (!key_null[i]) f_ksum += key_len[i];
      if (!value_null[i]) f_vsum += value_len[i];
    }
    if (take)
      commit_counts(r, dense_partition, take, f_tomb, f_knull, f_ksum,
                    f_vsum);
  } else {
    // Columnar section stores (klen/vlen stored VERBATIM, like
    // kta_pack_batch — sources write 0 for null keys/tombstones but the
    // layout carries whatever the column said).
    for (int64_t i = lo; i < hi; ++i)
      store_at<int16_t>(r.p16, c0 + (i - lo),
                        static_cast<int16_t>(dense_partition));
    for (int64_t i = lo; i < hi; ++i)
      store_at<uint16_t>(r.kl16, c0 + (i - lo),
                         static_cast<uint16_t>(key_len[i]));
    for (int64_t i = lo; i < hi; ++i)
      store_at<uint32_t>(r.vl32, c0 + (i - lo),
                         static_cast<uint32_t>(value_len[i]));
    for (int64_t i = lo; i < hi; ++i)
      r.fl8[c0 + (i - lo)] =
          (key_null[i] ? 1 : 0) | (value_null[i] ? 2 : 0);
  }
  // Extremes: scalar reduction, ONE table RMW.  The wire-v5 quantile
  // pass stashes the same tombstone-excluded sizes this loop derives.
  FrameStash qstash = stash_of(
      scratch, r.b, pack_scratch_cap(r.b, with_alive, alive_bits));
  int64_t ts_min = INT64_MAX, ts_max = INT64_MIN;
  int64_t sz_min = INT64_MAX, sz_max = 0;
  for (int64_t i = lo; i < hi; ++i) {
    int64_t ts_s = ts[i];
    if (ts_mode == 1)
      ts_s = ts_s >= 0 ? ts_s / 1000 : -((-ts_s + 999) / 1000);
    else if (ts_mode == 2)
      ts_s = ts_s < 0 ? 0 : ts_s / 1000;
    if (ts_s < ts_min) ts_min = ts_s;
    if (ts_s > ts_max) ts_max = ts_s;
    if (!value_null[i]) {
      const int64_t size =
          (key_null[i] ? 0 : int64_t(key_len[i])) + int64_t(value_len[i]);
      if (size < sz_min) sz_min = size;
      if (size > sz_max) sz_max = size;
      if (r.q64) qstash.size[qstash.nsz++] = size;
    }
  }
  if (take)
    commit_extremes(r, dense_partition, ts_min, ts_max, sz_min, sz_max,
                    true, sz_min != INT64_MAX || sz_max != 0);
  if (take && r.q64)
    quant_pass(r, dense_partition, qstash.size, qstash.nsz);
  // Dedupe + HLL as dedicated passes straight off the input columns.
  if (with_alive) {
    FrameStash stash = stash_of(
        scratch, r.b, pack_scratch_cap(r.b, with_alive, alive_bits));
    for (int64_t i = lo; i < hi; ++i) {
      if (key_null[i]) continue;
      stash.h32[stash.n] = h32[i];
      stash.alive[stash.n] = value_null[i] ? 0 : 1;
      ++stash.n;
    }
    dedupe_pass(r, scratch, stash.h32, stash.alive, stash.n);
  }
  if (r.with_hll == 1 || r.with_hll == 3) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t pos = c0 + (i - lo);
      if (key_null[i]) {
        if (r.with_hll == 1)
          store_at<uint16_t>(r.hll_a, pos, 0);
        else
          store_at<uint32_t>(r.hll_a, pos, 0);
        r.hll_b[pos] = 0;
      } else {
        const uint64_t h = splitmix64(h64[i]);
        const uint32_t bucket = static_cast<uint32_t>(h >> (64 - r.hll_p));
        if (r.with_hll == 1)
          store_at<uint16_t>(r.hll_a, pos, static_cast<uint16_t>(bucket));
        else
          store_at<uint32_t>(
              r.hll_a, pos,
              (static_cast<uint32_t>(dense_partition) << r.hll_p) | bucket);
        const uint64_t rest = h << r.hll_p;
        r.hll_b[pos] =
            rest == 0 ? static_cast<uint8_t>(64 - r.hll_p + 1)
                      : static_cast<uint8_t>(__builtin_clzll(rest) + 1);
      }
    }
  } else if (r.with_hll == 2) {
    FrameStash stash = stash_of(
        scratch, r.b, pack_scratch_cap(r.b, with_alive, alive_bits));
    for (int64_t i = lo; i < hi; ++i) {
      if (key_null[i]) continue;
      stash.h64[stash.n] = h64[i];
      ++stash.n;
    }
    hll_table_pass(r, dense_partition, stash.h64, stash.n);
  }
  scratch[0] = c0 + take;
  const int32_t hv = static_cast<int32_t>(scratch[0]);
  const int32_t hp =
      with_alive == 2 ? 0 : static_cast<int32_t>(scratch[1]);
  std::memcpy(out, &hv, 4);
  std::memcpy(out + 4, &hp, 4);
  return take;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Decompressors for Kafka record batches (kafka_codec.py): snappy raw blocks
// (plus the xerial chunked framing Kafka's Java client emits) and LZ4 frames.
// Python has neither in its stdlib; the shim supplies them so the wire client
// covers the common broker compression codecs without extra dependencies.

namespace {

// Raw snappy block decode (format: preamble varint = uncompressed length,
// then literal/copy tagged elements).  Returns bytes written or -1.
int64_t snappy_raw(const uint8_t* in, int64_t in_len, uint8_t* out,
                   int64_t out_cap) {
  int64_t ip = 0;
  // uncompressed length: LITTLE-endian base-128 varint (not zigzag)
  uint64_t ulen = 0;
  int shift = 0;
  while (ip < in_len) {
    uint8_t b = in[ip++];
    ulen |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
    if (shift > 35) return -1;
  }
  if (static_cast<int64_t>(ulen) > out_cap) return -1;
  int64_t op = 0;
  while (ip < in_len) {
    const uint8_t tag = in[ip++];
    const int type = tag & 3;
    if (type == 0) {  // literal
      int64_t len = (tag >> 2) + 1;
      if (len > 60) {
        const int extra = static_cast<int>(len) - 60;
        if (ip + extra > in_len) return -1;
        len = 0;
        for (int i = 0; i < extra; ++i)
          len |= static_cast<int64_t>(in[ip + i]) << (8 * i);
        len += 1;
        ip += extra;
      }
      if (ip + len > in_len || op + len > out_cap) return -1;
      std::memcpy(out + op, in + ip, len);
      ip += len;
      op += len;
    } else {  // copy
      int64_t len = 0, offset = 0;
      if (type == 1) {
        if (ip >= in_len) return -1;
        len = ((tag >> 2) & 7) + 4;
        offset = (static_cast<int64_t>(tag >> 5) << 8) | in[ip++];
      } else if (type == 2) {
        if (ip + 2 > in_len) return -1;
        len = (tag >> 2) + 1;
        offset = in[ip] | (static_cast<int64_t>(in[ip + 1]) << 8);
        ip += 2;
      } else {
        if (ip + 4 > in_len) return -1;
        len = (tag >> 2) + 1;
        offset = 0;
        for (int i = 0; i < 4; ++i)
          offset |= static_cast<int64_t>(in[ip + i]) << (8 * i);
        ip += 4;
      }
      if (offset <= 0 || offset > op || op + len > out_cap) return -1;
      // byte-by-byte: copies may overlap their own output (RLE)
      for (int64_t i = 0; i < len; ++i, ++op) out[op] = out[op - offset];
    }
  }
  return op == static_cast<int64_t>(ulen) ? op : -1;
}

inline uint32_t read_be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

inline uint32_t read_le32(const uint8_t* p) {
  return p[0] | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

// LZ4 block decode (literals + matches); returns bytes written or -1.
int64_t lz4_block(const uint8_t* in, int64_t in_len, uint8_t* out,
                  int64_t out_cap) {
  int64_t ip = 0, op = 0;
  while (ip < in_len) {
    const uint8_t token = in[ip++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      for (;;) {
        if (ip >= in_len) return -1;  // truncated length extension
        const uint8_t b = in[ip++];
        lit += b;
        if (b != 255) break;
      }
    }
    if (ip + lit > in_len || op + lit > out_cap) return -1;
    std::memcpy(out + op, in + ip, lit);
    ip += lit;
    op += lit;
    if (ip >= in_len) break;  // last sequence has no match
    if (ip + 2 > in_len) return -1;
    const int64_t offset = in[ip] | (static_cast<int64_t>(in[ip + 1]) << 8);
    ip += 2;
    if (offset == 0 || offset > op) return -1;
    int64_t mlen = (token & 0x0f);
    if (mlen == 15) {
      for (;;) {
        if (ip >= in_len) return -1;  // truncated length extension
        const uint8_t b = in[ip++];
        mlen += b;
        if (b != 255) break;
      }
    }
    mlen += 4;
    if (op + mlen > out_cap) return -1;
    for (int64_t i = 0; i < mlen; ++i, ++op) out[op] = out[op - offset];
  }
  return op;
}

}  // namespace

extern "C" {

// Snappy: accepts Kafka's xerial framing (magic \x82SNAPPY\x00, then
// [be32 block length][raw snappy block]...) or a bare raw block.
// Returns bytes written to out, or -1 on malformed input / short out_cap.
int64_t kta_snappy_decompress(const uint8_t* in, int64_t in_len, uint8_t* out,
                              int64_t out_cap) {
  if (!in || !out || in_len < 0) return -1;
  static const uint8_t kXerial[8] = {0x82, 'S', 'N', 'A', 'P', 'P', 'Y', 0};
  if (in_len >= 16 && std::memcmp(in, kXerial, 8) == 0) {
    int64_t ip = 16;  // magic + version + compat (be32 each)
    int64_t op = 0;
    while (ip + 4 <= in_len) {
      const int64_t blen = read_be32(in + ip);
      ip += 4;
      if (blen < 0 || ip + blen > in_len) return -1;
      const int64_t n = snappy_raw(in + ip, blen, out + op, out_cap - op);
      if (n < 0) return -1;
      ip += blen;
      op += n;
    }
    return ip == in_len ? op : -1;
  }
  return snappy_raw(in, in_len, out, out_cap);
}

// LZ4: accepts an LZ4 frame (magic 0x184D2204; content checksum and block
// checksums tolerated/skipped, dictionaries unsupported) or a bare block.
int64_t kta_lz4_decompress(const uint8_t* in, int64_t in_len, uint8_t* out,
                           int64_t out_cap) {
  if (!in || !out || in_len < 0) return -1;
  if (in_len >= 7 && read_le32(in) == 0x184D2204u) {
    int64_t ip = 4;
    const uint8_t flg = in[ip];
    ip += 2;  // FLG + BD
    const bool content_size = flg & 0x08;
    const bool block_checksum = flg & 0x10;
    const bool content_checksum = flg & 0x04;
    if (flg & 0x01) return -1;  // dictionaries unsupported
    if (content_size) ip += 8;
    ip += 1;  // header checksum
    int64_t op = 0;
    while (ip + 4 <= in_len) {
      const uint32_t bsize = read_le32(in + ip);
      ip += 4;
      if (bsize == 0) {  // EndMark
        if (content_checksum) ip += 4;
        return op;
      }
      const bool uncompressed = bsize & 0x80000000u;
      const int64_t blen = bsize & 0x7fffffffu;
      if (ip + blen > in_len) return -1;
      if (uncompressed) {
        if (op + blen > out_cap) return -1;
        std::memcpy(out + op, in + ip, blen);
        op += blen;
      } else {
        const int64_t n = lz4_block(in + ip, blen, out + op, out_cap - op);
        if (n < 0) return -1;
        op += n;
      }
      ip += blen;
      if (block_checksum) ip += 4;
    }
    return -1;  // missing EndMark
  }
  return lz4_block(in, in_len, out, out_cap);
}

}  // extern "C"
