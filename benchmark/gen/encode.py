"""Encode a topic's template batches as Kafka v2 record batches, in numpy.

Every template of every partition is laid out in one ``uint8`` buffer, at
``base_offset`` 0, uncompressed, with its CRC32-C. The layout of a record
(``varint`` is Kafka's zigzag varint):

    varint(length) attributes=0 varint(ts_delta) varint(offset_delta)
    varint(key_len | -1) key varint(value_len | -1) value varint(0 headers)

Record ``i`` of a template has ``ts_delta = offset_delta = i``. Values are
zero bytes: the analyzer reads their lengths, and no codec runs.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.gen.crc import crc32c_many
from benchmark.gen.topic import Topic

HEADER_BYTES = 61
#: Offset of the attributes field, where the CRC's coverage begins.
CRC_FROM = 21


def _zigzag(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    return np.where(v >= 0, 2 * v, -2 * v - 1)


def _varint_len(z: np.ndarray) -> np.ndarray:
    return 1 + (z >= 1 << 7) + (z >= 1 << 14) + (z >= 1 << 21) + (z >= 1 << 28)


def _put_varint(buf: np.ndarray, pos: np.ndarray, z: np.ndarray, nbytes: np.ndarray) -> None:
    for j in range(int(nbytes.max(initial=1))):
        sel = nbytes > j
        b = (z[sel] >> (7 * j)) & 0x7F
        b |= np.where(nbytes[sel] > j + 1, 0x80, 0)
        buf[pos[sel] + j] = b.astype(np.uint8)


def encode_templates(topic: Topic, threads: "int | None" = None) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """``(buf, starts, lens)``: template ``p * T + t`` is
    ``buf[starts[k] : starts[k] + lens[k]]``. The records are written by
    ``threads`` threads (default: one a CPU), a block of partitions each."""
    threads = threads or os.cpu_count() or 1
    P, T, R = topic.P, topic.T, topic.R
    n_tmpl = P * T
    zi = _zigzag(np.arange(R, dtype=np.int64))
    li = _varint_len(zi)
    klen = -1 if topic.keys is None else topic.keys.shape[1]
    zk = _zigzag(np.array([klen]))[0]
    lk = int(_varint_len(np.array([zk]))[0])
    kb = max(klen, 0)
    vlen = topic.vlen.reshape(n_tmpl, R).astype(np.int64)
    zv = _zigzag(vlen)
    lv = _varint_len(zv)
    body = 1 + 2 * li + lk + kb + lv + np.maximum(vlen, 0) + 1
    zb = _zigzag(body)
    lb = _varint_len(zb)
    rec = lb + body
    lens = HEADER_BYTES + rec.sum(axis=1)
    starts = np.zeros(n_tmpl, dtype=np.int64)
    starts[1:] = np.cumsum(lens)[:-1]
    buf = np.zeros(int(lens.sum()), dtype=np.uint8)
    pos0 = starts[:, None] + HEADER_BYTES + np.cumsum(rec, axis=1) - rec

    def write(lo: int, hi: int) -> None:
        sl = slice(lo * T, hi * T)
        pos = pos0[sl].reshape(-1)
        _put_varint(buf, pos, zb[sl].reshape(-1), lb[sl].reshape(-1))
        pos = pos + lb[sl].reshape(-1) + 1  # the attributes byte stays 0
        zi_, li_ = np.tile(zi, hi * T - lo * T), np.tile(li, hi * T - lo * T)
        _put_varint(buf, pos, zi_, li_)
        pos = pos + li_
        _put_varint(buf, pos, zi_, li_)
        pos = pos + li_
        for j in range(lk):
            buf[pos + j] = (zk >> (7 * j)) & 0x7F | (0x80 if j + 1 < lk else 0)
        pos = pos + lk
        if topic.keys is not None:
            keys = topic.keys[lo * T * R:hi * T * R]
            buf[pos[:, None] + np.arange(kb)] = keys
        pos = pos + kb
        _put_varint(buf, pos, zv[sl].reshape(-1), lv[sl].reshape(-1))
        # value bytes and the header count (varint 0) are already zero

    bounds = np.linspace(0, P, min(threads, P) + 1).astype(int)
    with ThreadPoolExecutor(len(bounds) - 1) as pool:
        for f in [pool.submit(write, lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:])]:
            f.result()
    mv = memoryview(buf)
    for k in range(n_tmpl):
        t = k % T
        struct.pack_into(
            ">qiibIhiqqqhii", mv, int(starts[k]),
            0, int(lens[k]) - 12, -1, 2, 0, 0, R - 1, int(topic.ts_ms[t, 0]),
            int(topic.ts_ms[t, -1]), -1, -1, -1, R,
        )
    crcs = crc32c_many(buf, starts + CRC_FROM, lens - CRC_FROM)
    for k in range(n_tmpl):
        struct.pack_into(">I", mv, int(starts[k]) + 17, int(crcs[k]))
    return buf, starts, lens
