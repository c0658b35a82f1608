/* A plain Kafka consumer of one partition, in C, for the broker's drain
 * rate: it fetches with Fetch v4 from offset 0 until `end`, reads every
 * response into one reused buffer and steps over the record batches to
 * the next offset, decoding nothing else.  So it needs far less of the
 * host per byte than the analyzer, and shows what the broker can serve. */

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

static void put16(uint8_t *p, int16_t v) { uint16_t u = htons((uint16_t)v); memcpy(p, &u, 2); }
static void put32(uint8_t *p, int32_t v) { uint32_t u = htonl((uint32_t)v); memcpy(p, &u, 4); }
static void put64(uint8_t *p, int64_t v) {
  put32(p, (int32_t)((uint64_t)v >> 32));
  put32(p + 4, (int32_t)(uint32_t)v);
}
static int16_t get16(const uint8_t *p) { uint16_t u; memcpy(&u, p, 2); return (int16_t)ntohs(u); }
static int32_t get32(const uint8_t *p) { uint32_t u; memcpy(&u, p, 4); return (int32_t)ntohl(u); }
static int64_t get64(const uint8_t *p) {
  return (int64_t)(((uint64_t)(uint32_t)get32(p) << 32) | (uint32_t)get32(p + 4));
}

static int send_all(int fd, const uint8_t *p, size_t n) {
  while (n) {
    ssize_t k = send(fd, p, n, 0);
    if (k <= 0) return -1;
    p += k;
    n -= (size_t)k;
  }
  return 0;
}

static int recv_all(int fd, uint8_t *p, size_t n) {
  while (n) {
    ssize_t k = recv(fd, p, n, 0);
    if (k <= 0) return -1;
    p += k;
    n -= (size_t)k;
  }
  return 0;
}

/* Read `partition` of `topic` from 127.0.0.1:`port` until offset `end`.
 * Returns the offset reached (`end`), or -1 on a failure: a socket
 * error, an error code in a response, or a response that does not move
 * the offset.  `*nbytes` gets the bytes of every response. */
int64_t bench_drain(int port, const char *topic, int32_t partition, int64_t end,
                    int32_t max_bytes, int32_t partition_max_bytes, int64_t *nbytes) {
  static const char client[] = "bench-drain";
  size_t tlen = strlen(topic), clen = sizeof(client) - 1;
  uint8_t req[256];
  size_t rlen = 4 + 2 + 2 + 4 + 2 + clen + 4 + 4 + 4 + 4 + 1 + 4 + 2 + tlen + 4 + 4 + 8 + 4;
  if (rlen > sizeof(req)) return -1;
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  struct sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  if (connect(fd, (struct sockaddr *)&addr, sizeof(addr)) < 0) {
    close(fd);
    return -1;
  }
  size_t cap = (size_t)max_bytes + (1u << 20);
  uint8_t *buf = malloc(cap);
  int64_t off = 0, total = 0;
  int32_t corr = 0;
  while (buf && off < end) {
    uint8_t *q = req;
    put32(q, (int32_t)(rlen - 4)); q += 4;
    put16(q, 1); q += 2;  /* Fetch */
    put16(q, 4); q += 2;
    put32(q, ++corr); q += 4;
    put16(q, (int16_t)clen); memcpy(q + 2, client, clen); q += 2 + clen;
    put32(q, -1); q += 4;  /* replica */
    put32(q, 500); q += 4;  /* max wait ms */
    put32(q, 1); q += 4;  /* min bytes */
    put32(q, max_bytes); q += 4;
    *q++ = 0;  /* isolation */
    put32(q, 1); q += 4;
    put16(q, (int16_t)tlen); memcpy(q + 2, topic, tlen); q += 2 + tlen;
    put32(q, 1); q += 4;
    put32(q, partition); q += 4;
    put64(q, off); q += 8;
    put32(q, partition_max_bytes);
    uint8_t head[4];
    if (send_all(fd, req, rlen) || recv_all(fd, head, 4)) break;
    size_t size = (size_t)get32(head);
    if (size > cap) {
      uint8_t *grown = realloc(buf, size);
      if (!grown) break;
      buf = grown;
      cap = size;
    }
    if (recv_all(fd, buf, size)) break;
    total += (int64_t)size + 4;
    const uint8_t *p = buf + 4 + 4, *stop_all = buf + size;  /* corr, throttle */
    int64_t before = off;
    int bad = 0;
    int32_t topics = get32(p);
    p += 4;
    for (int32_t ti = 0; ti < topics && !bad; ti++) {
      p += 2 + get16(p);
      int32_t np = get32(p);
      p += 4;
      for (int32_t pi = 0; pi < np && !bad; pi++) {
        int16_t err = get16(p + 4);
        p += 4 + 2 + 8 + 8;
        int32_t aborted = get32(p);
        p += 4 + (aborted > 0 ? 16 * (size_t)aborted : 0);
        int32_t rs = get32(p);
        p += 4;
        if (err != 0 || rs < 0 || p + rs > stop_all) { bad = 1; break; }
        const uint8_t *b = p, *stop = p + rs;
        while (b + 12 <= stop) {
          int32_t blen = get32(b + 8);
          if (b + 12 + blen > stop || blen < 27) break;
          off = get64(b) + get32(b + 23) + 1;
          b += 12 + blen;
        }
        p = stop;
      }
    }
    if (bad || off <= before) break;
  }
  free(buf);
  close(fd);
  *nbytes = total;
  return off >= end ? off : -1;
}
