"""A topic's template batches compressed, and the broker that serves them.

`compress_templates` takes the uncompressed v2 batches `encode.encode_templates`
lays out (one buffer, template after template), fills each record's value
with content a codec has something to work on, and writes every batch
again with its records section as one LZ4 frame (``lz4_frame.c``, built at
first use by `cbuild.library`): attributes 3, the new batch length, the
CRC32-C recomputed. The records are the template's own: the same keys,
value lengths, tombstones, timestamps and offsets, so the reference's
report of the topic is unchanged.

Values (``values`` in the configuration's topic):

- ``json``: printable JSON-like text, ``"fNN":`` fields from a fixed
  vocabulary, each a quoted word of a fixed list or up to 8 digits, cut to
  the record's value length (zero bytes would compress ~250x and make the
  decoder a memset);
- ``random``: uniform random bytes, which LZ4 cannot shrink, so every block
  is stored raw;

each record's drawn from a generator seeded by the topic's seed and the
record's place.

`CompressedTemplateBroker` is a `TemplateBroker` that serves these batches;
`CompressedBrokerProcess` runs it in a child process, as `BrokerProcess`
runs the plain one, and the child reports on standard error the bytes
before and after compression.
"""

from __future__ import annotations

import ctypes
import functools
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from benchmark.gen.broker import BrokerProcess, TemplateBroker, _Head
from benchmark.gen.cbuild import library
from benchmark.gen.crc import crc32c_many
from benchmark.gen.encode import CRC_FROM
from benchmark.gen.topic import Topic

_SRC = Path(__file__).resolve().with_name("lz4_frame.c")
#: Kafka's codec ids, the low three bits of a v2 batch's attributes.
CODECS = {"lz4": 3}
#: Value content → ``bench_lz4_batches``' fill mode.
VALUES = {"json": 1, "random": 2}
BLOCK_BYTES = 65536
#: Where a batch's 4-byte CRC32-C sits.
CRC_AT = 17


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = library(_SRC)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.bench_lz4_batches.argtypes = [p, p, p, i64, ctypes.c_int32, ctypes.c_uint64, i64,
                                      p, p, p]
    lib.bench_lz4_batches.restype = None
    lib.bench_xxh32.argtypes = [p, i64, ctypes.c_uint32]
    lib.bench_xxh32.restype = ctypes.c_uint32
    return lib


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 of ``data``, as the encoder computes its header checksum."""
    buf = np.frombuffer(data, dtype=np.uint8)
    return int(_lib().bench_xxh32(buf.ctypes.data, len(buf), seed))


def compress_templates(raw: np.ndarray, lens: np.ndarray, seed: int, values: str = "json",
                       codec: str = "lz4", threads: "int | None" = None,
                       ) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """``(buf, starts, lens)`` of the batches laid out back to back in
    ``raw`` (``lens`` each), compressed; ``raw``'s values are filled in
    place first. Batches are split over ``threads`` threads (default: one
    a CPU)."""
    if codec not in CODECS:
        raise ValueError(f"unsupported codec {codec!r}; the encoder writes {sorted(CODECS)}")
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    n = len(lens)
    starts = np.zeros(n, dtype=np.int64)
    starts[1:] = np.cumsum(lens)[:-1]
    if int(lens.sum()) != len(raw):
        raise ValueError("the batches do not fill the buffer back to back")
    caps = lens + 72 + 4 * -(-lens // BLOCK_BYTES)
    dst_starts = np.zeros(n, dtype=np.int64)
    dst_starts[1:] = np.cumsum(caps)[:-1]
    dst = np.empty(int(caps.sum()), dtype=np.uint8)
    dst_lens = np.zeros(n, dtype=np.int64)
    mode = VALUES[values]
    lib = _lib()

    def work(lo: int, hi: int) -> None:
        lib.bench_lz4_batches(raw.ctypes.data, starts[lo:].ctypes.data, lens[lo:].ctypes.data,
                              hi - lo, mode, seed & (2**64 - 1), lo, dst.ctypes.data,
                              dst_starts[lo:].ctypes.data, dst_lens[lo:].ctypes.data)

    threads = max(1, min(threads or os.cpu_count() or 1, n))
    bounds = np.linspace(0, n, threads + 1).astype(int)
    with ThreadPoolExecutor(threads) as pool:
        for f in [pool.submit(work, lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:])]:
            f.result()
    out_starts = np.zeros(n, dtype=np.int64)
    out_starts[1:] = np.cumsum(dst_lens)[:-1]
    out = np.empty(int(dst_lens.sum()), dtype=np.uint8)
    for k in range(n):
        out[out_starts[k]:out_starts[k] + dst_lens[k]] = dst[dst_starts[k]:dst_starts[k] + dst_lens[k]]
    del dst
    crcs = crc32c_many(out, out_starts + CRC_FROM, dst_lens - CRC_FROM)
    be = crcs.astype(">u4").view(np.uint8).reshape(n, 4)
    for j in range(4):
        out[out_starts + CRC_AT + j] = be[:, j]
    return out, out_starts, dst_lens


class CompressedTemplateBroker(TemplateBroker):
    """`TemplateBroker` whose templates are the topic's batches compressed
    with ``codec``, their values filled with ``values``."""

    def __init__(self, topic: Topic, windows: int, brokers: int = 1, head=None,
                 codec: str = "lz4", values: str = "json"):
        super().__init__(topic, windows, brokers, head)
        lens = np.array(self.tmpl_len, dtype=np.int64)
        #: Bytes of the uncompressed batches, and of the compressed ones.
        self.raw_bytes = int(lens.sum())
        buf, starts, clens = compress_templates(self._buf, lens, topic.seed, values, codec)
        self._buf = buf
        mv = memoryview(buf)
        self.tmpl_len = [int(x) for x in clens]
        self.tmpl_tail = [mv[int(s) + 8:int(s) + int(n)] for s, n in zip(starts, clens)]
        self.compressed_bytes = int(clens.sum())


def _compressed_broker_child(pipe, config: dict, seed: int, name: str, windows: int,
                             head: "int | None", head_conn) -> None:
    """`broker._broker_child` with the compressed broker: build, report the
    bytes and the ports, serve until told to stop, report CPU seconds."""
    t0 = time.monotonic()
    topic = Topic(config, seed, name=name)
    held = None if head is None else _Head(head, head_conn)
    t = config["topic"]
    broker = CompressedTemplateBroker(topic, windows, topic.brokers, held, t["compression"],
                                      t.get("values", "json")).start()
    n = len(broker.tmpl_len)
    print(f"bench: {config['topic']['compression']} templates: {n} batches, "
          f"{broker.raw_bytes} B -> {broker.compressed_bytes} B "
          f"(ratio {broker.raw_bytes / broker.compressed_bytes:.4f}; "
          f"{broker.raw_bytes / n:.1f} -> {broker.compressed_bytes / n:.1f} B a batch) "
          f"in {time.monotonic() - t0:.3f} s", file=sys.stderr, flush=True)
    pipe.send(broker.ports)
    try:
        pipe.recv()
    except EOFError:
        pass
    broker.stop()
    pipe.send(time.process_time())


class CompressedBrokerProcess(BrokerProcess):
    """`BrokerProcess` serving the compressed templates."""

    def __enter__(self) -> "CompressedBrokerProcess":
        self._pipe, child = self._ctx.Pipe()
        self._proc = self._ctx.Process(target=_compressed_broker_child,
                                       args=(child, *self._args, self._head_recv),
                                       daemon=True)
        self._proc.start()
        child.close()
        self._head_recv.close()
        return self

