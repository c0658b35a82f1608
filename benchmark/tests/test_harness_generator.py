"""The generator at tiny sizes: its bytes, its keys and sizes, its layout
and its broker, held against plain loops and the program's own encoder."""

from __future__ import annotations

import socket
import struct

import numpy as np
import pytest

from benchmark.gen import wire
from benchmark.gen.broker import BrokerProcess
from benchmark.gen.crc import crc32c_many
from benchmark.gen.encode import encode_templates
from benchmark.gen.topic import Topic, value_size_multiset
from benchmark.reference.hashes import fnv32_variant


def demo(**kw) -> dict:
    t = {"partitions": 3, "records_per_partition": 600, "records_per_batch": 50,
         "templates_per_partition": 4, "key_bytes": 9, "tombstone_share": 0.1,
         "value_bytes": {"min": 130, "max": 741, "mean": 261, "beta_a": 2.0}}
    t.update(kw)
    return {"name": "t", "topic": t}


def keyless() -> dict:
    return demo(key_bytes=None, tombstone_share=0.0,
                value_bytes={"min": 1024, "max": 1024, "mean": 1024})


def test_crc32c_check_value():
    buf = np.frombuffer(b"xx123456789", dtype=np.uint8)
    assert crc32c_many(buf, np.array([2]), np.array([9]))[0] == 0xE3069283


@pytest.mark.parametrize("config", [demo(), keyless()], ids=["keyed", "null-keys"])
def test_templates_equal_the_programs_encoder(config):
    from kafka_topic_analyzer_tpu_torch.io import kafka_codec as kc

    t = Topic(config, 2**31 + 5)
    buf, starts, lens = encode_templates(t, threads=2)
    for k in range(t.P * t.T):
        p, tt = divmod(k, t.T)
        recs = []
        for i in range(t.R):
            key = None if t.keys is None else bytes(t.keys[k * t.R + i])
            v = int(t.vlen[p, tt, i])
            recs.append((i, int(t.ts_ms[tt, i]), key, None if v < 0 else bytes(v)))
        assert bytes(buf[starts[k]:starts[k] + lens[k]]) == kc.encode_record_batch(recs)


def test_keys_are_salted_by_partition_and_keep_their_slots_apart():
    t = Topic(demo(partitions=4, templates_per_partition=8), 9)
    keys = t.keys.reshape(t.P, -1, 9)
    as_bytes = [{bytes(k) for k in keys[p]} for p in range(t.P)]
    assert all(len(s) == keys.shape[1] for s in as_bytes)  # distinct in a partition
    assert not set.intersection(*as_bytes[:2]) and not set.union(*as_bytes[1:]) & as_bytes[0]
    slots = fnv32_variant(t.keys).reshape(t.P, -1)
    owners: dict = {}
    for p in range(t.P):
        for s in set(slots[p].tolist()):
            assert owners.setdefault(s, p) == p


def test_null_keys_and_fixed_sizes():
    t = Topic(keyless(), 3)
    assert t.keys is None
    assert (t.vlen == 1024).all()


def test_tombstones_and_sizes_are_the_same_work_for_every_seed():
    a, b = Topic(demo(), 1), Topic(demo(), 2)
    for t in (a, b):
        assert ((t.vlen < 0).sum(axis=2) == 5).all()  # 10% of 50, in every template
    assert not np.array_equal(a.vlen, b.vlen)
    assert np.array_equal(np.sort(a.vlen, axis=None), np.sort(b.vlen, axis=None))


def test_size_distribution():
    sizes = value_size_multiset({"min": 130, "max": 741, "mean": 261, "beta_a": 2.0}, 200_000)
    assert sizes.min() == 130 and sizes.max() == 741
    assert abs(sizes.mean() - 261) < 1.0


def test_layout_against_a_loop():
    t = Topic(demo(), 4)
    heads = np.array([0, 5, 13])
    uses, last = t.template_uses(heads), t.last_window(heads)
    for p, h in enumerate(heads):
        for tt in range(t.T):
            ws = [w for w in range(h) if w % t.T == tt]
            assert uses[p, tt] == len(ws)
            assert last[p, tt] == (ws[-1] if ws else -1)


def _fetch_all(port: int, parts, topic: str) -> "dict[int, int]":
    """Read every partition from offset 0 to its end; records per partition."""
    s = socket.create_connection(("127.0.0.1", port))
    out = {}
    try:
        for p in parts:
            off, n = 0, 0
            while True:
                s.sendall(wire.request(wire.API_FETCH, 4, 1,
                                       wire.encode_fetch_request(topic, [(p, off)], 1 << 20, 1 << 16)))
                size = struct.unpack(">i", s.recv(4, socket.MSG_WAITALL))[0]
                resp = s.recv(size, socket.MSG_WAITALL)
                (_, err, start, nbytes), = wire.decode_fetch_response(memoryview(resp)[4:])
                if nbytes == 0:
                    break
                pos, stop = start + 4, start + 4 + nbytes
                while pos < stop:
                    base, blen = struct.unpack_from(">qi", resp, pos)
                    (delta,) = struct.unpack_from(">i", resp, pos + 23)
                    assert base == off
                    off = base + delta + 1
                    n += delta + 1
                    pos += 12 + blen
            out[p] = n
    finally:
        s.close()
    return out


def test_broker_serves_the_topic_and_its_head():
    config = demo(brokers=1)
    t = Topic(config, 8, name="t")
    with BrokerProcess(config, 8, "t", t.windows, head=3) as broker:
        (port,) = broker.wait_ready()
        assert _fetch_all(port, range(t.P), "t") == {p: 3 * t.R for p in range(t.P)}
        broker.set_head(7)
        # The head moves once the child has read it off its pipe.
        for _ in range(100):
            got = _fetch_all(port, [0], "t")
            if got[0] == 7 * t.R:
                break
        assert got[0] == 7 * t.R
    assert broker.cpu_s is not None and broker.cpu_s > 0


def test_native_drain_reads_every_partition_to_its_end():
    import ctypes

    from benchmark.gen import drain

    config = demo(brokers=2)
    t = Topic(config, 8, name="t")
    with BrokerProcess(config, 8, "t", t.windows) as broker:
        ports = broker.wait_ready()

        class Pipe:
            def send(self, x):
                self.got = x

        pipe = Pipe()
        drain.consume(pipe, ports, "t", list(range(t.P)), t.windows * t.R, 2)
        t0, t1, nbytes = pipe.got
        assert t1 >= t0 and nbytes > 2 * t.P * t.windows * t.R
        # A partition that does not exist fails, and says so.
        lib = drain.native_lib()
        n = ctypes.c_int64(0)
        assert lib.bench_drain(ports[0], b"t", t.P + 5, 10, 1 << 20, 1 << 16, ctypes.byref(n)) == -1
