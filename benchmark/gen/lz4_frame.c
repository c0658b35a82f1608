/* LZ4-compressed Kafka v2 record batches for the benchmark's broker.

   bench_lz4_batches takes uncompressed v2 batches (61-byte header, then
   the records section, as encode.py writes them) and writes each as the
   same batch with its records section compressed the way Kafka's
   KafkaLZ4BlockOutputStream does: one LZ4 frame, magic 0x184D2204, FLG
   0x60 (version 1, independent blocks, no checksums, no content size),
   BD 0x40 (64 KiB blocks), the header-checksum byte (xxh32(FLG BD, 0) >>
   8) & 0xFF, each block LZ4-compressed or stored raw (high bit of its
   size set) where that is not smaller, and the end mark 0. The header's
   attributes become 3 (LZ4) and its batch length the new one; the caller
   recomputes the CRC.

   Before compressing, the records' values may be filled in place: mode 1
   with printable JSON-like text ("fNN":<word or digits>, fields), mode 2
   with random bytes, each record's from a generator seeded by the seed
   and the record's index; mode 0 leaves them as they are. */

#include <stdint.h>
#include <string.h>

#define HEADER_BYTES 61
#define BLOCK_BYTES 65536
#define HASH_BITS 14
#define MIN_MATCH 4
#define MF_LIMIT 12
#define LAST_LITERALS 5

static uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

static uint32_t rd32le(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

static void wr32le(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)v;
  p[1] = (uint8_t)(v >> 8);
  p[2] = (uint8_t)(v >> 16);
  p[3] = (uint8_t)(v >> 24);
}

static void wr32be(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)(v >> 24);
  p[1] = (uint8_t)(v >> 16);
  p[2] = (uint8_t)(v >> 8);
  p[3] = (uint8_t)v;
}

static uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

/* xxHash32 of len bytes. */
uint32_t bench_xxh32(const uint8_t* p, int64_t len, uint32_t seed) {
  const uint32_t P1 = 2654435761u, P2 = 2246822519u, P3 = 3266489917u,
                 P4 = 668265263u, P5 = 374761393u;
  const uint8_t* end = p + len;
  uint32_t h;
  if (len >= 16) {
    uint32_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 16;
    do {
      v1 = rotl32(v1 + rd32le(p) * P2, 13) * P1;
      v2 = rotl32(v2 + rd32le(p + 4) * P2, 13) * P1;
      v3 = rotl32(v3 + rd32le(p + 8) * P2, 13) * P1;
      v4 = rotl32(v4 + rd32le(p + 12) * P2, 13) * P1;
      p += 16;
    } while (p <= limit);
    h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
  } else {
    h = seed + P5;
  }
  h += (uint32_t)len;
  while (p + 4 <= end) {
    h = rotl32(h + rd32le(p) * P3, 17) * P4;
    p += 4;
  }
  while (p < end) {
    h = rotl32(h + (*p) * P5, 11) * P1;
    p++;
  }
  h ^= h >> 15;
  h *= P2;
  h ^= h >> 13;
  h *= P3;
  h ^= h >> 16;
  return h;
}

/* One LZ4 block of src[0, n) into dst (at most cap bytes): greedy matches
   found through a hash of 4-byte words, the last 5 bytes literals and no
   match starting within 12 bytes of the end, as the block format asks.
   Returns the bytes written, or -1 if they would pass cap. */
static int64_t lz4_block(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int32_t table[1 << HASH_BITS];
  int64_t ip = 0, anchor = 0, op = 0;
  memset(table, 0xff, sizeof table);
  const int64_t mflimit = n - MF_LIMIT, matchlimit = n - LAST_LITERALS;
  while (ip < mflimit) {
    const uint32_t word = rd32(src + ip);
    const uint32_t h = (word * 2654435761u) >> (32 - HASH_BITS);
    const int64_t ref = table[h];
    table[h] = (int32_t)ip;
    if (ref < 0 || ip - ref > 65535 || rd32(src + ref) != word) {
      ip++;
      continue;
    }
    int64_t mlen = MIN_MATCH;
    while (ip + mlen < matchlimit && src[ref + mlen] == src[ip + mlen]) mlen++;
    const int64_t lit = ip - anchor;
    if (op + 1 + lit / 255 + 1 + lit + 2 + (mlen - MIN_MATCH) / 255 + 1 > cap) return -1;
    uint8_t* token = dst + op++;
    if (lit >= 15) {
      *token = 15 << 4;
      int64_t l = lit - 15;
      for (; l >= 255; l -= 255) dst[op++] = 255;
      dst[op++] = (uint8_t)l;
    } else {
      *token = (uint8_t)(lit << 4);
    }
    memcpy(dst + op, src + anchor, lit);
    op += lit;
    const int64_t off = ip - ref;
    dst[op++] = (uint8_t)off;
    dst[op++] = (uint8_t)(off >> 8);
    int64_t m = mlen - MIN_MATCH;
    if (m >= 15) {
      *token |= 15;
      for (m -= 15; m >= 255; m -= 255) dst[op++] = 255;
      dst[op++] = (uint8_t)m;
    } else {
      *token |= (uint8_t)m;
    }
    ip += mlen;
    anchor = ip;
  }
  const int64_t lit = n - anchor;
  if (op + 1 + lit / 255 + 1 + lit > cap) return -1;
  uint8_t* token = dst + op++;
  if (lit >= 15) {
    *token = 15 << 4;
    int64_t l = lit - 15;
    for (; l >= 255; l -= 255) dst[op++] = 255;
    dst[op++] = (uint8_t)l;
  } else {
    *token = (uint8_t)(lit << 4);
  }
  memcpy(dst + op, src + anchor, lit);
  return op + lit;
}

/* src[0, n) as one LZ4 frame at dst; returns its length. dst holds at
   least n + 11 + 4 * ceil(n / BLOCK_BYTES) bytes. */
int64_t bench_lz4_frame(const uint8_t* src, int64_t n, uint8_t* dst) {
  int64_t op = 0;
  wr32le(dst, 0x184D2204u);
  dst[4] = 0x60;
  dst[5] = 0x40;
  dst[6] = (uint8_t)((bench_xxh32(dst + 4, 2, 0) >> 8) & 0xFF);
  op = 7;
  for (int64_t at = 0; at < n; at += BLOCK_BYTES) {
    const int64_t len = n - at < BLOCK_BYTES ? n - at : BLOCK_BYTES;
    const int64_t c = lz4_block(src + at, len, dst + op + 4, len - 1);
    if (c > 0) {
      wr32le(dst + op, (uint32_t)c);
      op += 4 + c;
    } else {
      wr32le(dst + op, 0x80000000u | (uint32_t)len);
      memcpy(dst + op + 4, src + at, len);
      op += 4 + len;
    }
  }
  wr32le(dst + op, 0);
  return op + 4;
}

static uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

static const char* const WORDS[] = {
    "true", "false", "null", "active", "pending", "shipped", "cancelled",
    "eu-west-1", "us-east-1", "ap-south-1", "android", "ios", "web",
    "checkout", "login", "search", "click", "view", "EUR", "USD", "GBP",
    "de-DE", "en-US", "fr-FR", "premium", "basic", "trial", "ok", "error",
    "timeout", "mobile", "desktop",
};
#define N_WORDS (sizeof WORDS / sizeof WORDS[0])

/* n bytes of JSON-like text: one record's fields "f00":value, in the
   schema's fixed order, cut at n. Even fields hold a quoted word, one of
   four of the vocabulary's that are the field's own; odd fields digits:
   an event time in ms a few ms after the record before it (field 1 mod 6;
   ``when`` is the record's place in the topic), a count of 1 to 3 digits
   (3 mod 6), an id of 5 to 7 digits (5 mod 6). */
static void fill_json(uint8_t* out, int64_t n, uint64_t* s, uint64_t when) {
  char field[48];
  int64_t at = 0;
  for (int f = 0; at < n; f = (f + 1) % 20) {
    const uint64_t r = splitmix64(s);
    int k = 0;
    field[k++] = '"';
    field[k++] = 'f';
    field[k++] = (char)('0' + f / 10);
    field[k++] = (char)('0' + f % 10);
    field[k++] = '"';
    field[k++] = ':';
    if (f % 2 == 0) {
      const char* w = WORDS[(f * 4 + r % 4) % N_WORDS];
      field[k++] = '"';
      for (; *w; ++w) field[k++] = *w;
      field[k++] = '"';
    } else {
      uint64_t d = r >> 8;
      int digits = f % 6 == 3 ? 1 + (int)(r % 3) : 5 + (int)(r % 3);
      if (f % 6 == 1) {
        d = 1577836800000ull + when * 4 + r % 4;
        digits = 13;
      }
      for (int j = digits - 1; j >= 0; --j, d /= 10) field[k + j] = (char)('0' + d % 10);
      k += digits;
    }
    field[k++] = ',';
    const int64_t take = n - at < k ? n - at : k;
    memcpy(out + at, field, take);
    at += take;
  }
}

static void fill_random(uint8_t* out, int64_t n, uint64_t* s) {
  for (int64_t at = 0; at < n; at += 8) {
    const uint64_t r = splitmix64(s);
    const int64_t take = n - at < 8 ? n - at : 8;
    memcpy(out + at, &r, take);
  }
}

/* Kafka's zigzag varint at *p (advanced past it). */
static int64_t varint(const uint8_t** p) {
  uint64_t v = 0;
  int shift = 0;
  for (;;) {
    const uint8_t b = *(*p)++;
    v |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  return (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
}

/* Fill the values of one batch's records section rec[0, n) in place;
   record i's generator starts from seed and (index * 2^20 + i). */
static void fill_values(uint8_t* rec, int64_t n, int mode, uint64_t seed, int64_t index) {
  const uint8_t* p = rec;
  for (int64_t i = 0; p < rec + n; ++i) {
    const int64_t len = varint(&p);
    const uint8_t* next = p + len;
    p += 1;        /* attributes */
    varint(&p);    /* timestamp delta */
    varint(&p);    /* offset delta */
    const int64_t klen = varint(&p);
    if (klen > 0) p += klen;
    const int64_t vlen = varint(&p);
    if (vlen > 0) {
      uint64_t at = (uint64_t)index * (1ull << 20) + (uint64_t)i;
      uint64_t s = seed ^ splitmix64(&at);
      uint8_t* v = rec + (p - rec);
      if (mode == 1) fill_json(v, vlen, &s, (uint64_t)index * 1024 + (uint64_t)i);
      else fill_random(v, vlen, &s);
    }
    p = next;
  }
}

/* n uncompressed batches src[starts[k], starts[k] + lens[k]) written
   compressed at dst[dst_starts[k]...), their lengths in dst_lens. Batch k
   is batch (first + k) of the topic, for the values' generators. dst_starts
   leave each batch lens[k] + 72 + 4 * ceil(lens[k] / BLOCK_BYTES) bytes. */
void bench_lz4_batches(uint8_t* src, const int64_t* starts, const int64_t* lens, int64_t n,
                       int32_t mode, uint64_t seed, int64_t first, uint8_t* dst,
                       const int64_t* dst_starts, int64_t* dst_lens) {
  for (int64_t k = 0; k < n; ++k) {
    uint8_t* in = src + starts[k];
    uint8_t* out = dst + dst_starts[k];
    const int64_t rec_len = lens[k] - HEADER_BYTES;
    if (mode) fill_values(in + HEADER_BYTES, rec_len, mode, seed, first + k);
    memcpy(out, in, HEADER_BYTES);
    const int64_t total =
        HEADER_BYTES + bench_lz4_frame(in + HEADER_BYTES, rec_len, out + HEADER_BYTES);
    wr32be(out + 8, (uint32_t)(total - 12)); /* batch length */
    out[21] = 0;                             /* attributes: LZ4 */
    out[22] = 3;
    dst_lens[k] = total;
  }
}
