"""A loopback Kafka cluster that serves several topics from their template
batches: the TPC-C change-data-capture topics (`benchmark.gen.tpcc_cdc`).

`ClusterBroker` is `broker.TemplateBroker` with one template set a topic
behind one set of ports: metadata (all topics, for a fleet's discovery, or
those asked for), list-offsets and fetch requests are routed by topic
name. A partition shows the windows it holds (``heads[p]``), each template
once; partition ``p`` of the ``k``-th topic is led by node
``(k + p) % brokers``. A fetch is served as `TemplateBroker` serves it:
the iovecs of whole batches, their ``base_offset`` patched, within the
request's per-partition and request-level byte budgets.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from benchmark.gen import wire
from benchmark.gen.broker import BrokerProcess, TemplateBroker
from benchmark.gen.crc import crc32c_many
from benchmark.gen.encode import encode_templates
from benchmark.gen.tpcc_cdc import TpccCdc


class _Served:
    """One topic's encoded templates and where they are served."""

    def __init__(self, topic, index: int):
        buf, starts, lens = encode_templates(topic, threads=1)
        self._buf = buf
        mv = memoryview(buf)
        self.tmpl_len = [int(x) for x in lens]
        self.tmpl_tail = [mv[int(s) + 8:int(s) + int(n)] for s, n in zip(starts, lens)]
        self.name = topic.name
        self.index = index
        self.P, self.T, self.R = topic.P, topic.T, topic.R
        self.heads = [int(h) for h in topic.heads]


class ClusterBroker(TemplateBroker):
    """Serve every topic of ``topics`` (each with ``heads``, the windows a
    partition holds) from ``brokers`` listener sockets."""

    def __init__(self, topics, brokers: int = 1):
        # Build the CRC library once, before the topics' threads load it.
        crc32c_many(np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64),
                    np.zeros(0, dtype=np.int64))
        with ThreadPoolExecutor(len(topics)) as pool:
            served = list(pool.map(_Served, topics, range(len(topics))))
        self.topics = {s.name: s for s in served}
        self._socks: List[socket.socket] = []
        self.ports: List[int] = []
        for _ in range(max(1, brokers)):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            s.listen(64)
            self._socks.append(s)
            self.ports.append(s.getsockname()[1])
        self._stop = threading.Event()

    def _fetch_topic(self, name: str, parts, max_bytes: int) -> list:
        t = self.topics.get(name)
        budget = max_bytes
        served_any = False
        raw = name.encode()
        iov = [struct.pack(">iiH", 0, 1, len(raw)) + raw + struct.pack(">i", len(parts))]
        for pid, offset, pmax in parts:
            if t is None or not 0 <= pid < t.P:
                iov.append(struct.pack(">ihqqii", pid, wire.ERR_UNKNOWN_TOPIC_OR_PARTITION,
                                       -1, -1, 0, 0))
                continue
            R, visible = t.R, t.heads[pid]
            end = visible * R
            w0 = offset // R  # align down; clients skip the records below
            lim = min(pmax, budget)
            n = size = 0
            base = pid * t.T
            while w0 + n < visible and (size < lim or (n == 0 and not served_any)):
                size += t.tmpl_len[base + w0 + n]
                n += 1
            served_any = served_any or n > 0
            budget = max(0, budget - size)
            iov.append(struct.pack(">ihqqii", pid, 0, end, end, 0, size))
            for w in range(w0, w0 + n):
                iov.append(struct.pack(">q", w * R))
                iov.append(t.tmpl_tail[base + w])
        return iov

    def _dispatch(self, api_key: int, api_version: int, r: wire.Reader):
        if api_key == wire.API_VERSIONS:
            return wire.encode_api_versions_response()
        nb = len(self.ports)
        if api_key == wire.API_METADATA:
            asked = wire.decode_metadata_request(r)
            out = []
            for name in asked or sorted(self.topics):
                t = self.topics.get(name)
                if t is None:
                    out.append((wire.ERR_UNKNOWN_TOPIC_OR_PARTITION, name, []))
                else:
                    out.append((0, name, [(p, (t.index + p) % nb) for p in range(t.P)]))
            brokers = {i: ("127.0.0.1", port) for i, port in enumerate(self.ports)}
            return wire.encode_metadata_response(brokers, out, api_version)
        if api_key == wire.API_LIST_OFFSETS:
            name, parts = wire.decode_list_offsets_request(r)
            t = self.topics.get(name)
            results = []
            for pid, ts in parts:
                if t is None or not 0 <= pid < t.P:
                    results.append((pid, wire.ERR_UNKNOWN_TOPIC_OR_PARTITION, -1, -1))
                elif ts == wire.EARLIEST_TIMESTAMP:
                    results.append((pid, 0, -1, 0))
                elif ts == wire.LATEST_TIMESTAMP:
                    results.append((pid, 0, -1, t.heads[pid] * t.R))
                else:
                    results.append((pid, 0, ts, 0))
            return wire.encode_list_offsets_response(name, results)
        if api_key == wire.API_FETCH:
            name, parts, max_bytes = wire.decode_fetch_request(r)
            return self._fetch_topic(name, parts, max_bytes)
        raise ValueError(f"benchmark cluster: unsupported api {api_key}")


def _cluster_child(pipe, config: dict, seed: int) -> None:
    """Build the configuration's topics and serve them, report the ports,
    block until told to stop; then report this process's CPU seconds."""
    db = TpccCdc(config, seed)
    broker = ClusterBroker(db.topics, int(config["topic"].get("brokers", 1))).start()
    pipe.send(broker.ports)
    try:
        pipe.recv()
    except EOFError:
        pass
    broker.stop()
    pipe.send(time.process_time())


class ClusterProcess(BrokerProcess):
    """`ClusterBroker` over the topics of ``TpccCdc(config, seed)``, in a
    child process of its own (`BrokerProcess`'s lifecycle; no head)."""

    def __init__(self, config: dict, seed: int):
        import multiprocessing as mp

        self._ctx = mp.get_context("spawn")
        self._args = (config, seed)
        self.ports: List[int] = []
        self.cpu_s: "float | None" = None

    def __enter__(self) -> "ClusterProcess":
        self._pipe, child = self._ctx.Pipe()
        self._proc = self._ctx.Process(target=_cluster_child, args=(child, *self._args),
                                       daemon=True)
        self._proc.start()
        child.close()
        return self
