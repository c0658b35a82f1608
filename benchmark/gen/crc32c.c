/* CRC32-C (Castagnoli) of many slices of one buffer: the checksum Kafka's
 * v2 record batches carry.  The generator encodes a topic's template
 * batches in numpy and checksums them here in one call.  With SSE4.2 the
 * hardware instruction does the work; without it a byte table does. */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#if !defined(__SSE4_2__)
static uint32_t table[256];
static int table_ready;

static void make_table(void) {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
    table[i] = c;
  }
  table_ready = 1;
}
#endif

static uint32_t crc32c(const uint8_t* p, size_t n) {
#if defined(__SSE4_2__)
  uint64_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint64_t v;
    memcpy(&v, p, 8);
    c = __builtin_ia32_crc32di(c, v);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = (uint32_t)c;
  while (n--) c32 = __builtin_ia32_crc32qi(c32, *p++);
  return c32 ^ 0xFFFFFFFFu;
#else
  if (!table_ready) make_table();
  uint32_t c = 0xFFFFFFFFu;
  while (n--) c = table[(c ^ *p++) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
#endif
}

/* out[i] = CRC32-C of buf[starts[i] : starts[i] + lens[i]]. */
void bench_crc32c_many(const uint8_t* buf, const int64_t* starts,
                       const int64_t* lens, int64_t n, uint32_t* out) {
  for (int64_t i = 0; i < n; i++) out[i] = crc32c(buf + starts[i], (size_t)lens[i]);
}
