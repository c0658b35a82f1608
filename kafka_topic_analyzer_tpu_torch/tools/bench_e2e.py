"""A fast loopback Kafka broker for end-to-end runs of the wire scan, and
the runner that scans it (port of the reference's ``tools/bench_e2e.py``:
`build_templates`, `TemplateBroker`, `BrokerProcess` and ``run`` with
every flag of the reference's runner, plus ``--device``).

    python -m kafka_topic_analyzer_tpu_torch.tools.bench_e2e \
        --records 16000000 --brokers 4 --ingest-workers auto

``run`` times one scan of the template topic through the real engine
(`engine.run_scan`, the same path as ``--source kafka``) and prints one
JSON line with records/s and ``vs_baseline``, its ratio to the
reference's published 590,221 msgs/s, which also times the whole consume
pipeline.

The serving side must be far faster than the client under test, so the
broker never encodes per record at fetch time.  It pre-encodes a small set
of **template RecordBatches** (base_offset 0) and serves every offset
window as a template copy with the base_offset header patched in place.
That is valid Kafka wire data: the v2 batch CRC32-C covers attributes
onward and excludes base_offset/batch_length/leader_epoch/magic/crc
(io/kafka_codec.py:encode_record_batch), and record offset deltas are
relative to base_offset, so an 8-byte patch retargets a batch to any
window at memcpy speed.  Distinct templates carry distinct key sets, so
the alive-key and HLL paths see ``templates × records_per_batch`` unique
keys cycling through the topic.  Window ``w`` of every partition is
template ``w % templates``.

A broker can serve a moving head: ``head`` (anything with a ``.value``,
such as a ``multiprocessing.Value``) holds the number of windows visible
per partition, and the end watermark and every fetch respect it, so a
follow scan sees records arrive when the owner raises it
(`BrokerProcess.set_head`).

    with BrokerProcess(topic="t", partitions=16, windows=250, R=4000,
                       n_templates=64, vmin=100, vmax=300,
                       compression=0, tombstone_every=10) as port:
        ...  # python -m kafka_topic_analyzer_tpu_torch -t t -b 127.0.0.1:PORT
"""

from __future__ import annotations

import argparse
import json
import socket
import struct
import sys
import threading
import time
from typing import List, Optional

import numpy as np

from kafka_topic_analyzer_tpu_torch.io import kafka_codec as kc

BASELINE_MSGS_PER_SEC = 590_221.0


def build_templates(
    records_per_batch: int,
    n_templates: int,
    vmin: int,
    vmax: int,
    seed: int = 7,
    compression: int = kc.COMPRESSION_NONE,
    tombstone_every: int = 0,
    salt: "int | None" = None,
) -> List[bytes]:
    """Encode ``n_templates`` RecordBatches (base_offset 0) with disjoint
    key sets and seeded value sizes in [vmin, vmax].  A ``salt`` prefixes
    every key (``s<salt>-``) and moves the size seed by ``salt``, so the
    topics of one broker hold different keys; None keeps the unsalted
    keys."""
    rng = np.random.default_rng(seed + (salt or 0))
    base_ts = 1_767_225_600_000  # 2026-01-01T00:00:00Z, ms
    prefix = b"" if salt is None else b"s%d-" % salt
    out = []
    for t in range(n_templates):
        sizes = rng.integers(vmin, vmax + 1, size=records_per_batch)
        recs: List[kc.OffsetRecord] = []
        for i in range(records_per_batch):
            key = prefix + b"k%04d-%08d" % (t, i)
            if tombstone_every and i % tombstone_every == (t % tombstone_every):
                value = None
            else:
                value = bytes(int(sizes[i]))
            recs.append((i, base_ts + i, key, value))
        out.append(kc.encode_record_batch(recs, compression=compression))
    return out


def _sendmsg_all(conn: socket.socket, bufs: "list") -> None:
    """sendall semantics for a scatter-gather buffer list (sendmsg may
    send partially; resume from the exact byte)."""
    views = [memoryview(b) for b in bufs]
    i = 0
    while i < len(views):
        sent = conn.sendmsg(views[i : i + 512])
        while i < len(views) and sent >= len(views[i]):
            sent -= len(views[i])
            i += 1
        if sent:
            views[i] = views[i][sent:]


class _TopicLayout:
    """One served topic: its partitions, windows and templates, whether it
    is flagged internal, and the shared head it follows (None: all of its
    windows are visible)."""

    def __init__(self, name: str, partitions: int, windows: int,
                 templates: List[bytes], records_per_batch: int,
                 internal: bool = False, head=None):
        self.name = name
        self.partitions = list(range(partitions))
        self.partition_set = set(self.partitions)
        self.windows = windows
        self.templates = templates
        #: Template split for scatter-gather serving: the first 8 bytes of
        #: a v2 frame are base_offset (not CRC-covered), so a response is
        #: [8-byte patched header][shared template tail] pairs — the tails
        #: are served zero-copy straight from these views by sendmsg.
        self.tmpl_tails = [memoryview(t)[8:] for t in templates]
        self.R = records_per_batch
        self.internal = internal
        self.head = head

    @property
    def visible_windows(self) -> int:
        """Windows of every partition the broker serves right now."""
        if self.head is None:
            return self.windows
        return max(0, min(self.windows, int(self.head.value)))

    @property
    def end_offset(self) -> int:
        return self.visible_windows * self.R


class TemplateBroker:
    """Loopback Kafka broker serving base_offset-patched template batches.

    Speaks exactly the APIs the wire client negotiates (ApiVersions v0,
    Metadata v1–v5, ListOffsets v1, Fetch v4) and honors both byte budgets
    of a Fetch request — partition_max_bytes per partition and the KIP-74
    request-level max_bytes (first batch always served whole).

    ``extra_topics`` (`_TopicLayout` list) serves more topics from the
    same bootstrap (fleet runs): an all-topics Metadata request lists
    every topic with its internal flag, and ListOffsets and Fetch route by
    the request's topic name.
    """

    def __init__(
        self,
        topic: str,
        partitions: int,
        windows_per_partition: int,
        templates: List[bytes],
        records_per_batch: int,
        brokers: int = 1,
        head=None,
        extra_topics: "List[_TopicLayout] | None" = None,
    ):
        main = _TopicLayout(topic, partitions, windows_per_partition,
                            templates, records_per_batch, head=head)
        #: Served topics by name, the default topic first.
        self.layouts = {main.name: main}
        for layout in extra_topics or []:
            if layout.name in self.layouts:
                raise ValueError(f"topic {layout.name!r} served twice")
            self.layouts[layout.name] = layout
        self.topic = topic
        #: N listener sockets = N advertised broker nodes (partition p is
        #: led by node p % N) — exercises the wire client's
        #: leader-parallel fetch the way a real multi-broker cluster does.
        self._socks: List[socket.socket] = []
        self.ports: List[int] = []
        for _ in range(max(1, brokers)):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            s.listen(16)
            self._socks.append(s)
            self.ports.append(s.getsockname()[1])
        self.port = self.ports[0]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    @property
    def visible_windows(self) -> int:
        """Windows of every partition of the default topic served now."""
        return self.layouts[self.topic].visible_windows

    @property
    def end_offset(self) -> int:
        return self.layouts[self.topic].end_offset

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "TemplateBroker":
        for s in self._socks:
            t = threading.Thread(
                target=self._accept_loop, args=(s,), daemon=True
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass

    def __enter__(self) -> "TemplateBroker":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _accept_loop(self, sock: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return bytes(buf)

    # -- serving -------------------------------------------------------------

    def _serve(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                head = self._recv_exact(conn, 4)
                if head is None:
                    return
                (length,) = struct.unpack(">i", head)
                payload = self._recv_exact(conn, length)
                if payload is None:
                    return
                api_key, api_version, corr, _client, r = (
                    kc.decode_request_header(payload)
                )
                body = self._dispatch(api_key, api_version, r)
                # Fetch responses are iovec lists served scatter-gather:
                # sendmsg lets the kernel read the shared template tails
                # directly — zero Python-side assembly of the ~64 MB body.
                if isinstance(body, list):
                    total = sum(len(b) for b in body)
                    _sendmsg_all(
                        conn,
                        [struct.pack(">ii", 4 + total, corr)] + body,
                    )
                else:
                    conn.sendall(struct.pack(">ii", 4 + len(body), corr))
                    conn.sendall(body)

    def _fetch_response(self, layout: _TopicLayout, parts, max_bytes: int) -> "list":
        """Build the Fetch v4 response as an iovec list: small packed
        header chunks interleaved with the SHARED template tails (the
        first 8 bytes of each frame — base_offset, not CRC-covered — are
        per-window header chunks).  sendmsg serves the tails zero-copy, so
        the serving side never assembles the multi-MB body at all and
        stays far faster than the client under test.

        Budgets mirror a real broker: per-partition ``partition_max_bytes``
        and the KIP-74 request-level ``max_bytes``, with the first
        non-empty partition always granted one whole batch (minOneMessage),
        which the wire client's starvation logic relies on."""
        K = len(layout.templates)
        R = layout.R
        visible = layout.visible_windows
        end_offset = visible * R
        plan = []  # (pid, err, first_window, n_windows, rs_bytes)
        budget = max_bytes
        served_any = False
        for pid, fetch_offset, pmax, _epoch in parts:
            if pid not in layout.partition_set:
                plan.append((pid, kc.ERR_UNKNOWN_TOPIC_OR_PARTITION, 0, 0, 0))
                continue
            w0 = fetch_offset // R  # align down; clients skip below
            lim = min(pmax, budget)
            n = 0
            size = 0
            while w0 + n < visible and (
                size < lim or (n == 0 and not served_any)
            ):
                size += len(layout.templates[(w0 + n) % K])
                n += 1
            if n:
                served_any = True
            budget = max(0, budget - size)
            plan.append((pid, 0, w0, n, size))

        topic_b = layout.name.encode()
        head = struct.pack(
            ">iiH", 0, 1, len(topic_b)
        ) + topic_b + struct.pack(">i", len(plan))
        iov = [head]
        for pid, err, w0, n, size in plan:
            iov.append(
                struct.pack(
                    ">ihqqii", pid, err, end_offset,
                    end_offset, 0, size,
                )
            )
            for i in range(n):
                w = w0 + i
                iov.append(struct.pack(">q", w * R))
                iov.append(layout.tmpl_tails[w % K])
        return iov

    def _dispatch(self, api_key: int, api_version: int, r: kc.ByteReader) -> bytes:
        if api_key == kc.API_VERSIONS:
            return kc.encode_api_versions_response(
                [
                    (kc.API_FETCH, 0, 4),
                    (kc.API_LIST_OFFSETS, 0, 1),
                    (kc.API_METADATA, 0, 5),
                ]
            )
        if api_key == kc.API_METADATA:
            requested = []
            n = r.i32()
            for _ in range(max(n, 0)):
                requested.append(r.string())
            nb = len(self.ports)
            topics = []
            # A null (or empty) topic array asks for every topic.
            for name in requested or list(self.layouts):
                layout = self.layouts.get(name)
                if layout is None:
                    topics.append(kc.TopicMetadata(
                        kc.ERR_UNKNOWN_TOPIC_OR_PARTITION, name or "", []
                    ))
                    continue
                topics.append(kc.TopicMetadata(
                    0, name,
                    [kc.PartitionMetadata(0, p, p % nb) for p in layout.partitions],
                    is_internal=int(layout.internal),
                ))
            return kc.encode_metadata_response(
                kc.MetadataResponse(
                    {i: ("127.0.0.1", port) for i, port in enumerate(self.ports)},
                    0,
                    topics,
                ),
                version=api_version,
            )
        if api_key == kc.API_LIST_OFFSETS:
            topic, parts = kc.decode_list_offsets_request(r)
            layout = self.layouts.get(topic)
            results = []
            for pid, ts in parts:
                if layout is None or pid not in layout.partition_set:
                    results.append(
                        (pid, kc.ERR_UNKNOWN_TOPIC_OR_PARTITION, -1, -1)
                    )
                elif ts == kc.EARLIEST_TIMESTAMP:
                    results.append((pid, 0, -1, 0))
                elif ts == kc.LATEST_TIMESTAMP:
                    results.append((pid, 0, -1, layout.end_offset))
                else:
                    results.append((pid, 0, ts, 0))
            return kc.encode_list_offsets_response(topic, results)
        if api_key == kc.API_FETCH:
            topic, parts, _mw, _mb, max_bytes = kc.decode_fetch_request(r)
            layout = self.layouts.get(topic)
            if layout is None:
                layout = _TopicLayout(topic, 0, 0, [], 1)  # every pid unknown
            return self._fetch_response(layout, parts, max_bytes)
        raise AssertionError(f"bench broker: unsupported api {api_key}")


def topic_layout(spec: dict, compression: int, head=None) -> _TopicLayout:
    """The `_TopicLayout` of one ``extra_topics`` entry of `BrokerProcess`:
    ``name``, ``partitions``, ``windows``, ``R``, ``n_templates``,
    ``vmin``, ``vmax``, ``salt`` and optionally ``tombstone_every``,
    ``internal`` and ``follow_head`` (the topic's visible windows follow
    the broker's moving head)."""
    templates = build_templates(
        spec["R"], spec["n_templates"], spec["vmin"], spec["vmax"],
        compression=compression,
        tombstone_every=spec.get("tombstone_every", 0), salt=spec["salt"],
    )
    return _TopicLayout(
        spec["name"], spec["partitions"], spec["windows"], templates,
        spec["R"], internal=spec.get("internal", False),
        head=head if spec.get("follow_head") else None,
    )


def _broker_child(pipe, topic, partitions, windows, R, n_templates,
                  vmin, vmax, compression, tombstone_every,
                  brokers, head=None, extra_topics=()) -> None:
    """Subprocess entry: build templates, serve, report the port, block.

    The broker must live in its own process — in-process serving steals
    GIL time from the client under test and the measurement stops being
    a client-side number."""
    templates = build_templates(
        R, n_templates, vmin, vmax,
        compression=compression, tombstone_every=tombstone_every,
    )
    broker = TemplateBroker(
        topic, partitions, windows, templates, R, brokers=brokers, head=head,
        extra_topics=[topic_layout(spec, compression, head)
                      for spec in extra_topics],
    )
    broker.start()
    pipe.send(broker.port)
    pipe.recv()  # parent says stop (or EOFError on parent death)


class BrokerProcess:
    """TemplateBroker in a child process; context manager yields the port.

    ``head=N`` starts a moving head with N windows visible per partition
    (of ``windows``); `set_head` moves it from the parent.
    ``extra_topics`` (a list of `topic_layout` dicts) serves more topics
    from the same bootstrap, each with keys salted by its ``salt``; those
    with ``follow_head`` follow the same head."""

    def __init__(self, **kw):
        self._kw = kw
        self._head = None

    def set_head(self, windows: int) -> None:
        """Make ``windows`` windows of every partition visible (the
        records arrive at the broker, as far as any client can tell)."""
        self._head.value = int(windows)

    def __enter__(self) -> int:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        if self._kw.get("head") is not None:
            self._head = ctx.Value("q", int(self._kw["head"]), lock=False)
        self._parent, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_broker_child,
            args=(
                child,
                self._kw["topic"], self._kw["partitions"], self._kw["windows"],
                self._kw["R"], self._kw["n_templates"], self._kw["vmin"],
                self._kw["vmax"], self._kw["compression"],
                self._kw.get("tombstone_every", 0),
                self._kw.get("brokers", 1),
                self._head,
                list(self._kw.get("extra_topics", ())),
            ),
            daemon=True,
        )
        self._proc.start()
        if not self._parent.poll(120):
            self._proc.terminate()
            raise RuntimeError("bench broker failed to start within 120s")
        return self._parent.recv()

    def __exit__(self, *exc) -> None:
        try:
            self._parent.send("stop")
        except OSError:
            pass
        self._proc.join(5)
        if self._proc.is_alive():
            self._proc.terminate()


def run(argv: "list[str] | None" = None) -> int:
    """Scan a `BrokerProcess` topic end to end through the engine and
    print one JSON line: records/s, the resolved dispatch and ingest
    workers, the scan doctor's verdict with ``--flight-record`` or
    ``--service-obs``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--partitions", type=int, default=16)
    ap.add_argument("--records", type=int, default=50_000_000,
                    help="total logical records served across partitions")
    ap.add_argument("--batch-size", type=int, default=1 << 20)
    ap.add_argument("--records-per-batch", type=int, default=4096,
                    help="records per wire RecordBatch (template size)")
    ap.add_argument("--templates", type=int, default=16,
                    help="distinct templates (keys = templates x "
                         "records-per-batch)")
    ap.add_argument("--features", default="counters",
                    help="comma set: counters,alive,hll,quantiles "
                         "(default matches the reference's headline scan)")
    ap.add_argument("--backend", default="gpu", choices=["cpu", "tpu", "gpu"],
                    help="the CLI's backends: cpu is the numpy exact oracle, "
                         "gpu (or its reference spelling tpu) the torch "
                         "backend on --device")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the torch backend runs")
    ap.add_argument("--vmin", type=int, default=100)
    ap.add_argument("--vmax", type=int, default=420)
    ap.add_argument("--compression", default="none",
                    choices=["none", "gzip", "snappy", "lz4", "zstd"])
    ap.add_argument("--tombstone-every", type=int, default=0,
                    help="make every Nth template record a tombstone "
                         "(0 = none)")
    ap.add_argument("--brokers", type=int, default=1,
                    help="advertised broker nodes (partition p led by "
                         "p %% N) — exercises leader-parallel fetching")
    ap.add_argument("--alive-bits", type=int, default=26)
    ap.add_argument("--wire-format", choices=["v4", "v5"], default="v5",
                    help="packed wire format: v5 combiner rows or v4 "
                         "per-record columns")
    ap.add_argument("--alive-compaction", choices=["auto", "off"],
                    default="auto",
                    help="'auto' = one bounded per-dispatch pair table, "
                         "'off' = per-row pair sections")
    ap.add_argument("--superbatch", default="1", metavar="K|auto",
                    help="fold K packed batches per dispatch (torch "
                         "backend; 'auto' targets 2^20 records per "
                         "dispatch)")
    ap.add_argument("--dispatch-depth", type=int, default=2,
                    help="dispatches allowed in flight while the device "
                         "folds (default 2)")
    ap.add_argument("--ingest-workers", default="1", metavar="N|auto",
                    help="partition-sharded parallel ingest workers for "
                         "the scan (engine --ingest-workers; composes "
                         "with --mesh: one fan-in per data row)")
    ap.add_argument("--mesh", default="1", metavar="DATA[,SPACE]",
                    help="device mesh of the sharded backend (torch "
                         "backend; shards round-robin on the visible CUDA "
                         "devices, or the host under --device cpu): the "
                         "mesh x workers sweep")
    ap.add_argument("--flight-record", action="store_true",
                    help="run the pipeline flight recorder during the "
                         "scan and print the doctor's BOTTLENECK verdict")
    ap.add_argument("--service-obs", metavar="DIR",
                    help="run the whole service-observability stack during "
                         "the scan: the flight recorder, the telemetry "
                         "history persisted under DIR and the alert "
                         "engine: its overhead against a plain run")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from kafka_topic_analyzer_tpu_torch.io import native
    from kafka_topic_analyzer_tpu_torch.backends.base import make_backend
    from kafka_topic_analyzer_tpu_torch.cli import (
        parse_mesh,
        resolve_dispatch,
        resolve_ingest_workers,
    )
    from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
    from kafka_topic_analyzer_tpu_torch.engine import run_scan
    from kafka_topic_analyzer_tpu_torch.io.kafka_wire import KafkaWireSource
    from kafka_topic_analyzer_tpu_torch.obs import flight as obs_flight
    from kafka_topic_analyzer_tpu_torch.obs import health as obs_health
    from kafka_topic_analyzer_tpu_torch.obs import history as obs_history
    from kafka_topic_analyzer_tpu_torch.obs.doctor import diagnose_scan

    feats = {f.strip() for f in args.features.split(",") if f.strip()}
    R = args.records_per_batch
    windows = max(1, args.records // (args.partitions * R))
    total = windows * R * args.partitions
    comp = {
        "none": kc.COMPRESSION_NONE,
        "gzip": kc.COMPRESSION_GZIP,
        "snappy": kc.COMPRESSION_SNAPPY,
        "lz4": kc.COMPRESSION_LZ4,
        "zstd": kc.COMPRESSION_ZSTD,
    }[args.compression]
    try:
        mesh_shape = parse_mesh(args.mesh)
        if mesh_shape != (1, 1) and args.backend == "cpu":
            raise ValueError("--mesh requires --backend tpu")
        dispatch = resolve_dispatch(args)
        ingest_workers = resolve_ingest_workers(args, args.partitions)
    except ValueError as e:
        ap.error(str(e))
    config = AnalyzerConfig(
        num_partitions=args.partitions,
        batch_size=args.batch_size,
        count_alive_keys="alive" in feats,
        alive_bitmap_bits=args.alive_bits,
        enable_hll="hll" in feats,
        enable_quantiles="quantiles" in feats,
        mesh_shape=mesh_shape,
        wire_format={"v4": 4, "v5": 5}[args.wire_format],
        alive_compaction=args.alive_compaction,
    )
    use_native = native.native_available()
    if mesh_shape != (1, 1):
        from kafka_topic_analyzer_tpu_torch.parallel.sharded import (
            ShardedTorchBackend,
        )

        backend = ShardedTorchBackend(config, device=args.device,
                                      use_native=use_native, dispatch=dispatch)
    else:
        backend = make_backend(args.backend, config, device=args.device,
                               use_native=use_native, dispatch=dispatch)
    with BrokerProcess(
        topic="bench-e2e", partitions=args.partitions, windows=windows,
        R=R, n_templates=args.templates, vmin=args.vmin, vmax=args.vmax,
        compression=comp, tombstone_every=args.tombstone_every,
        brokers=args.brokers,
    ) as port:
        source = KafkaWireSource(
            f"127.0.0.1:{port}", "bench-e2e", use_native_hashing=use_native
        )
        recorder = None
        store = None
        if args.flight_record or args.service_obs:
            recorder = obs_flight.FlightRecorder()
            if args.service_obs:
                store = obs_history.HistoryStore(args.service_obs)
                recorder.attach_history(store)
                obs_history.set_active(store)
                obs_health.set_active(obs_health.HealthEngine())
            obs_flight.set_active(recorder)
            recorder.start()
        try:
            t0 = time.perf_counter()
            # finalize copies the state to the host: the device is done.
            result = run_scan(
                "bench-e2e", source, backend, args.batch_size,
                ingest_workers=ingest_workers,
            )
            elapsed = time.perf_counter() - t0
            # Read inside the recorder's life, as --stats reads it.
            diagnosis = diagnose_scan(result) if recorder is not None else None
        finally:
            # A failing scan must not leak a live sampler as the
            # process-wide active recorder, nor an open history store.
            if recorder is not None:
                recorder.stop()
                obs_flight.set_active(None)
            if store is not None:
                store.close()
                obs_history.set_active(None)
                obs_health.set_active(None)
            source.close()
    got = int(result.metrics.overall_count)
    if got != total:
        print(f"bench-e2e: scanned {got} records, expected {total}",
              file=sys.stderr)
        return 1
    value = total / elapsed
    if not args.quiet:
        print(
            f"# e2e: {total} records, {args.partitions} partitions, "
            f"{elapsed:.2f}s, backend={args.backend}, "
            f"features={sorted(feats)}, compression={args.compression}",
            file=sys.stderr,
        )
    doc = {
        "metric": "e2e_msgs_per_sec",
        "value": round(value),
        "unit": "msgs/s",
        "vs_baseline": round(value / BASELINE_MSGS_PER_SEC, 2),
        "records": total,
        "seconds": elapsed,
        "device": "cpu" if backend.device is None else str(backend.device),
        "superbatch_k": result.superbatch_k,
        "dispatch_depth": result.dispatch_depth,
        "ingest_workers": result.ingest_workers,
        "ingest_workers_per_controller": result.ingest_workers_per_controller,
        "mesh": list(mesh_shape),
        "batch_size": args.batch_size,
        "brokers": args.brokers,
    }
    if diagnosis is not None:
        from kafka_topic_analyzer_tpu_torch.report import render_bottleneck

        if not args.quiet:
            sys.stderr.write(render_bottleneck(diagnosis))
        doc["flight"] = {
            "verdict": diagnosis.verdict,
            "stages": {k: round(v, 4) for k, v in diagnosis.stages.items()},
            "window_share": {
                k: round(v, 4) for k, v in diagnosis.window_share.items()
            },
        }
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(run())
