"""The port's remote segment tier (``io/objstore.py``, ``io/segstore.py``'s
``ObjectSegmentStore``, ``io/segfile.py``'s ``RemoteSegmentFile``) against
the reference's, through the port's own S3-shaped server
(``tools/objstore_serve.py``, scripted by `PortFakeObjectStore`).

The reference's remote-tier tests, run against the port: object-store
scans equal local-directory scans of the same chunks across workers ×
superbatch × readahead, under injected transport faults (drop, 503,
stall, truncated body, ETag mismatch, a server that ignores Range, LIST
across pages), through the local segment cache (cold/warm, poison,
stale entries, the LRU bound), and across cross-store resume.  Then the
port against the reference itself: the port's remote report equals the
reference's remote scan and CLI, a fetch fault degrades a partition
(exit 3) and leaves a snapshot that ``--resume`` completes, and a warm
cache hit — a read-only memory map — reaches the fused native pass and
``pack_batch(out=)`` without a copy.
"""

import json
import os
import threading
from collections import Counter

import numpy as np
import pytest

from kafka_topic_analyzer_tpu_torch.backends.cpu import CpuExactBackend
from kafka_topic_analyzer_tpu_torch.config import (
    AnalyzerConfig,
    SegmentFetchConfig,
    TransportRetryConfig,
)
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.io.segfile import (
    MalformedSegmentError,
    SegmentFileSource,
    write_segment_from_batches,
)
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.tools.objstore_serve import ObjectStoreHttpServer

pytestmark = pytest.mark.objstore


class PortFakeObjectStore(ObjectStoreHttpServer):
    """The port's server with the reference test fake's scripting layer
    (tests/fake_objstore.py): per-object fault scripts consumed FIFO by
    successive whole-body GETs (header and list probes stay clean unless
    ``body_only=False``), and a count of body GETs per key."""

    def __init__(self, root, **kw):
        self._script_lock = threading.Lock()
        self._scripts: "dict[str, list]" = {}
        self.body_gets: "Counter[str]" = Counter()
        super().__init__(root, fault_hook=self._hook, **kw)

    def script(self, key: str, *actions, body_only: bool = True) -> None:
        with self._script_lock:
            self._scripts.setdefault(key, []).extend(
                (a, body_only) for a in actions
            )

    def _hook(self, key, rng, index):
        with self._script_lock:
            if rng is None:
                self.body_gets[key] += 1
            queue = self._scripts.get(key)
            if not queue:
                return None
            action, body_only = queue[0]
            if body_only and rng is not None:
                return None
            queue.pop(0)
            return action


FakeObjectStore = PortFakeObjectStore

SPEC = SyntheticSpec(
    num_partitions=3,
    messages_per_partition=2_000,
    keys_per_partition=90,
    tombstone_permille=130,
    seed=11,
)
#: Fast-failing retry schedule for fault tests (no real sleeping to speak
#: of; the budget semantics are what is under test).
FAST_RETRY = TransportRetryConfig(
    backoff_ms=1, backoff_max_ms=4, retry_budget=4
)


def fetch_cfg(readahead=2, cache=None, retry=FAST_RETRY, timeout=5.0):
    return SegmentFetchConfig(
        readahead=readahead, cache_dir=cache, retry=retry, timeout_s=timeout
    )


@pytest.fixture()
def seg_dir(tmp_path):
    src = SyntheticSource(SPEC)
    d = tmp_path / "segs"
    d.mkdir()
    for p in src.partitions():
        write_segment_from_batches(
            str(d), "t", p, list(src.batches(700, partitions=[p]))
        )
    return str(d)


def cpu_cfg(**kw):
    base = dict(
        num_partitions=3, batch_size=700, count_alive_keys=True,
        alive_bitmap_bits=18, enable_hll=True, hll_p=8,
    )
    base.update(kw)
    return AnalyzerConfig(**base)


def scan_doc(result):
    d = result.metrics.to_dict(result.start_offsets, result.end_offsets)
    d["degraded"] = dict(result.degraded_partitions)
    return d


def metric_total(name):
    m = default_registry().snapshot().get(name)
    if not m:
        return 0.0
    return sum(s["value"] for s in m["samples"])


# ---------------------------------------------------------------------------
# store factory / spec parsing


def test_open_segment_store_routes_remote_schemes(seg_dir, monkeypatch):
    from kafka_topic_analyzer_tpu_torch.io.objstore import parse_object_store_spec
    from kafka_topic_analyzer_tpu_torch.io.segstore import (
        ObjectSegmentStore,
        open_segment_store,
    )

    assert isinstance(
        open_segment_store("http://127.0.0.1:9/bucket"), ObjectSegmentStore
    )
    assert isinstance(
        open_segment_store("https://s3.example.com/bucket/p"),
        ObjectSegmentStore,
    )
    assert isinstance(open_segment_store("s3://bucket/pre"), ObjectSegmentStore)
    # s3:// resolves through KTA_S3_ENDPOINT, path-style.
    monkeypatch.setenv("KTA_S3_ENDPOINT", "http://minio.local:9000")
    assert parse_object_store_spec("s3://arch/orders") == (
        False, "minio.local", 9000, "/arch/orders"
    )
    assert parse_object_store_spec("http://h:81/b") == (False, "h", 81, "/b")
    assert parse_object_store_spec("https://h/b")[:3] == (True, "h", 443)
    with pytest.raises(ValueError, match="bad object store spec"):
        parse_object_store_spec("ftp://nope")


def test_unknown_scheme_lists_supported(tmp_path):
    from kafka_topic_analyzer_tpu_torch.io.segstore import open_segment_store

    with pytest.raises(ValueError, match="not supported") as e:
        open_segment_store("gs://bucket/prefix")
    for spelled in ("file://", "http://", "https://", "s3://", "plug-in"):
        assert spelled in str(e.value)


def test_cache_rejected_for_local_store(seg_dir, tmp_path):
    from kafka_topic_analyzer_tpu_torch.io.segstore import open_segment_store

    with pytest.raises(ValueError, match="--segment-cache only applies"):
        open_segment_store(
            seg_dir, fetch=fetch_cfg(cache=str(tmp_path / "c"))
        )


# ---------------------------------------------------------------------------
# catalog over the wire


def test_remote_catalog_uses_header_probes_only(seg_dir):
    with FakeObjectStore(seg_dir) as store:
        src = SegmentFileSource(store.url, "t", fetch=fetch_cfg())
        # Validation complete (header↔name, ordering, sizes) with ZERO
        # chunk bodies downloaded.
        assert sum(store.body_gets.values()) == 0
        local = SegmentFileSource(seg_dir, "t")
        assert src.partitions() == local.partitions()
        assert src.watermarks() == local.watermarks()
        assert src.partition_record_counts() == local.partition_record_counts()
        assert src.readahead == 2  # the explicit fetch_cfg depth


def test_remote_catalog_auto_readahead_and_gappy_end_offsets(tmp_path):
    from kafka_topic_analyzer_tpu_torch.io.kafka_wire import records_to_batch
    from kafka_topic_analyzer_tpu_torch.io.segfile import SegmentDumpWriter
    from kafka_topic_analyzer_tpu_torch.records import RecordBatch

    rows = [
        (0, 1_600_000_000_000 + off, f"k{off % 7}".encode(), bytes(12))
        for off in range(0, 300, 3)
    ]
    batch = records_to_batch(rows)
    batch.offsets = np.arange(0, 300, 3, dtype=np.int64)
    writer = SegmentDumpWriter(str(tmp_path), "gap", records_per_chunk=40)
    for lo in range(0, 100, 25):
        writer.append(batch.take(np.arange(lo, lo + 25)))
    writer.close()

    with FakeObjectStore(str(tmp_path)) as store:
        src = SegmentFileSource(store.url, "gap")  # default fetch config
        assert src.readahead == 4  # auto resolves to 4 for remote stores
        # Offset-exact watermarks from the 8-byte suffix probes — still no
        # body fetches.
        assert src.watermarks() == (({0: 0}), ({0: 298}))
        assert sum(store.body_gets.values()) == 0
        # Offset-exact resume mid-chunk (this one does read bodies).
        resumed = RecordBatch.concat(list(src.batches(50, start_at={0: 151})))
        assert int(resumed.offsets[0]) == 153


def _write_gappy_chunks(tmp_path):
    from kafka_topic_analyzer_tpu_torch.io.kafka_wire import records_to_batch
    from kafka_topic_analyzer_tpu_torch.io.segfile import SegmentDumpWriter

    rows = [
        (0, 1_600_000_000_000 + off, f"k{off % 7}".encode(), bytes(12))
        for off in range(0, 300, 3)
    ]
    batch = records_to_batch(rows)
    batch.offsets = np.arange(0, 300, 3, dtype=np.int64)
    writer = SegmentDumpWriter(str(tmp_path), "gap", records_per_chunk=40)
    for lo in range(0, 100, 25):
        writer.append(batch.take(np.arange(lo, lo + 25)))
    writer.close()


def test_resume_plan_probes_only_the_straddling_chunk(tmp_path):
    """Resuming mid-archive must touch exactly ONE chunk's offsets column
    at plan time (the chunk straddling the resume point): probing every
    remaining gappy chunk would synchronously download the rest of the
    archive up front and pin it all in memory."""
    _write_gappy_chunks(tmp_path)  # c0 = offsets 0..147, c1 = 150..297
    with FakeObjectStore(str(tmp_path)) as store:
        src = SegmentFileSource(store.url, "gap", fetch=fetch_cfg(0))
        it = src.batches(50, start_at={0: 100})
        got = next(it)
        assert int(got.offsets[0]) == 102
        it.close()
        # c0 straddles 100 and is probed; c1 is entirely above the resume
        # point and must not be fetched at plan time.
        assert store.body_gets["gap-0.c0.ktaseg"] == 1
        assert store.body_gets["gap-0.c1.ktaseg"] == 0


def test_resume_plan_probe_failure_degrades_not_crashes(tmp_path):
    """A plan-time offsets probe that exhausts the partition's transport
    budget degrades that partition (the degraded surface) — it must not
    escape batches() and crash the resumed scan."""
    _write_gappy_chunks(tmp_path)
    with FakeObjectStore(str(tmp_path)) as store:
        store.script("gap-0.c0.ktaseg", *[("status", 503)] * 32)
        src = SegmentFileSource(store.url, "gap", fetch=fetch_cfg(0))
        assert list(src.batches(50, start_at={0: 100})) == []
        assert list(src.degraded_partitions()) == [0]
        assert "failures" in src.degraded_partitions()[0]


def test_prefixed_store_spec_lists_and_fetches(seg_dir):
    """A /bucket/some/prefix spec must LIST against the BUCKET with the
    key prefix folded into ?prefix=, and GET prefixed keys — a prefixed
    archive layout scans byte-identically to the flat one."""
    cfg = cpu_cfg()
    ref = scan_doc(run_scan(
        "t", SegmentFileSource(seg_dir, "t"),
        CpuExactBackend(cfg, init_now_s=10**10), 700,
    ))
    objects = {
        f"arch/2026/{name}": data
        for name, data in _as_dict_root(seg_dir).items()
    }
    with FakeObjectStore(objects, bucket="tiered") as store:
        spec = f"http://127.0.0.1:{store.port}/tiered/arch/2026"
        src = SegmentFileSource(spec, "t", fetch=fetch_cfg(2))
        assert src.partitions() == [0, 1, 2]
        got = run_scan(
            "t", src, CpuExactBackend(cfg, init_now_s=10**10), 700
        )
        assert scan_doc(got) == ref
        assert store.body_gets["arch/2026/t-0.ktaseg"] == 1


# ---------------------------------------------------------------------------
# the acceptance matrix: remote == local across workers × K × readahead


def test_remote_scan_matches_local_matrix(seg_dir):
    from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
    from kafka_topic_analyzer_tpu_torch.config import DispatchConfig

    cfg = cpu_cfg(batch_size=256, enable_quantiles=True)
    ref = scan_doc(run_scan(
        "t", SegmentFileSource(seg_dir, "t"),
        TorchBackend(cfg, device="cpu", init_now_s=10**10), 256,
    ))
    with FakeObjectStore(seg_dir) as store:
        for workers in (1, 4):
            for k in (1, 4):
                for readahead in (0, 2):
                    backend = TorchBackend(cfg, device="cpu", init_now_s=10**10,
                        dispatch=DispatchConfig(superbatch=k),
                    )
                    got = run_scan(
                        "t",
                        SegmentFileSource(
                            store.url, "t", fetch=fetch_cfg(readahead)
                        ),
                        backend, 256, ingest_workers=workers,
                    )
                    assert got.superbatch_k == k
                    assert got.ingest_workers == min(workers, 3)
                    assert scan_doc(got) == ref, (workers, k, readahead)
    # Every per-stream read-ahead pool drained and settled: the occupancy
    # gauge must be back at zero.
    assert metric_total("kta_segstore_readahead_occupancy") == 0


# ---------------------------------------------------------------------------
# fault injection: transient → retried, persistent → degraded


def test_mid_get_faults_are_retried_to_identity(seg_dir):
    cfg = cpu_cfg()
    ref = scan_doc(run_scan(
        "t", SegmentFileSource(seg_dir, "t"),
        CpuExactBackend(cfg, init_now_s=10**10), 700,
    ))
    retries0 = metric_total("kta_segstore_retries_total")
    with FakeObjectStore(seg_dir) as store:
        # One mid-GET connection drop, one 5xx, one stall past the client
        # timeout — three distinct transient kinds on three chunks.
        store.script("t-0.ktaseg", "drop")
        store.script("t-1.ktaseg", ("status", 503))
        store.script("t-2.ktaseg", ("stall", 1.0))
        got = run_scan(
            "t",
            SegmentFileSource(
                store.url, "t", fetch=fetch_cfg(readahead=2, timeout=0.4)
            ),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
    assert scan_doc(got) == ref
    assert got.degraded_partitions == {}
    assert metric_total("kta_segstore_retries_total") - retries0 >= 3


def test_truncated_mid_get_is_transient_not_corrupt(seg_dir):
    cfg = cpu_cfg()
    ref = scan_doc(run_scan(
        "t", SegmentFileSource(seg_dir, "t"),
        CpuExactBackend(cfg, init_now_s=10**10), 700,
    ))
    with FakeObjectStore(seg_dir) as store:
        # Body cut short mid-GET (headers claim full length): must retry,
        # not classify — the object at rest is intact.
        store.script("t-0.ktaseg", ("truncate", 500))
        got = run_scan(
            "t",
            SegmentFileSource(store.url, "t", fetch=fetch_cfg(0)),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
    assert scan_doc(got) == ref


def test_retry_budget_exhaustion_degrades_partition(seg_dir):
    cfg = cpu_cfg()
    with FakeObjectStore(seg_dir) as store:
        store.script("t-1.ktaseg", *[("status", 500)] * 32)
        got = run_scan(
            "t",
            SegmentFileSource(store.url, "t", fetch=fetch_cfg(2)),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
    # Partition 1 degraded with the budget reason; the others finished.
    assert list(got.degraded_partitions) == [1]
    assert "consecutive transport failures" in got.degraded_partitions[1]
    assert got.metrics.overall_count == 2 * SPEC.messages_per_partition
    assert got.metrics.total(0) == SPEC.messages_per_partition
    assert got.metrics.total(1) == 0
    # The engine persists the degraded surface identically to a dead wire
    # partition: the scan result exposes it for EXIT_DEGRADED.
    assert metric_total("kta_retry_budget_exhaustions_total") >= 1


def test_list_pagination_enumerates_full_catalog(seg_dir):
    """S3 caps a LIST page at 1000 keys: the client must follow
    NextContinuationToken until IsTruncated clears, or an archive larger
    than one page silently loses its lexicographic tail."""
    from kafka_topic_analyzer_tpu_torch.io.objstore import RetryingHttp

    def list_gets():
        snap = default_registry().snapshot().get("kta_segstore_gets_total")
        return sum(
            s["value"] for s in (snap or {"samples": []})["samples"]
            if s["labels"].get("kind") == "list"
        )

    objects = {f"t-{i}.ktaseg": b"x" * 8 for i in range(25)}
    with FakeObjectStore(objects, max_keys=10) as store:
        http = RetryingHttp(store.url, fetch_cfg())
        lists0 = list_gets()
        names = sorted(n for n, _ in http.list_objects("t-"))
        assert names == sorted(objects)  # all 25 …
        assert list_gets() - lists0 == 3  # … across 3 pages
    # And end-to-end: a scan against a paginating store (3 chunks, 2-key
    # pages) stays byte-identical to the local reference.
    cfg = cpu_cfg()
    ref = scan_doc(run_scan(
        "t", SegmentFileSource(seg_dir, "t"),
        CpuExactBackend(cfg, init_now_s=10**10), 700,
    ))
    with FakeObjectStore(seg_dir, max_keys=2) as store:
        got = run_scan(
            "t",
            SegmentFileSource(store.url, "t", fetch=fetch_cfg(0)),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
    assert scan_doc(got) == ref


def test_sse_kms_etag_is_not_treated_as_damage(seg_dir):
    """SSE-KMS objects carry 32-hex ETags that are NOT the content MD5.
    The response declares the encryption, so the MD5 check must be
    skipped outright — a healthy encrypted archive must not burn retry
    budget (let alone degrade) on 'body MD5 does not match ETag'."""
    cfg = cpu_cfg()
    ref = scan_doc(run_scan(
        "t", SegmentFileSource(seg_dir, "t"),
        CpuExactBackend(cfg, init_now_s=10**10), 700,
    ))
    retries0 = metric_total("kta_segstore_retries_total")
    with FakeObjectStore(seg_dir, sse="aws:kms", etag_salt=b"kms") as store:
        got = run_scan(
            "t",
            SegmentFileSource(store.url, "t", fetch=fetch_cfg(0)),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
        # No re-fetches at all: every chunk body downloaded exactly once.
        assert all(v == 1 for v in store.body_gets.values())
    assert scan_doc(got) == ref
    assert got.degraded_partitions == {}
    assert metric_total("kta_segstore_retries_total") - retries0 == 0


def test_persistent_etag_mismatch_accepted_after_one_refetch(seg_dir):
    """A 32-hex non-MD5 ETag WITHOUT the SSE header (proxy-stripped
    headers, composite ETags): the first mismatch is presumed in-flight
    damage and re-fetched once; byte-identical data on the second fetch
    proves it persistent — accepted, booked, and LATCHED for the whole
    store (ETag policy is bucket-level), so an archived year pays one
    extra fetch total, not 2x egress."""
    cfg = cpu_cfg()
    ref = scan_doc(run_scan(
        "t", SegmentFileSource(seg_dir, "t"),
        CpuExactBackend(cfg, init_now_s=10**10), 700,
    ))
    booked0 = metric_total("kta_segstore_fallback_total")
    with FakeObjectStore(seg_dir, etag_salt=b"not-md5") as store:
        got = run_scan(
            "t",
            SegmentFileSource(store.url, "t", fetch=fetch_cfg(0)),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
        # ONE chunk pays the disambiguating re-fetch; the latch spares
        # the rest of the store.
        assert sum(store.body_gets.values()) == 4
        assert sorted(store.body_gets.values()) == [1, 1, 2]
    assert scan_doc(got) == ref
    assert got.degraded_partitions == {}
    assert metric_total("kta_segstore_fallback_total") - booked0 == 1
    snap = default_registry().snapshot()["kta_segstore_fallback_total"]
    assert any(
        s["labels"].get("reason") == "etag-not-md5" and s["value"] >= 1
        for s in snap["samples"]
    )


def test_range_ignoring_server_is_sliced_not_retried(seg_dir):
    """An endpoint that answers ranged GETs with 200 + the full object:
    the requested window is sliced out client-side (booked) — the
    catalog's header probes must not burn the retry budget calling the
    full body 'truncated'."""
    cfg = cpu_cfg()
    ref = scan_doc(run_scan(
        "t", SegmentFileSource(seg_dir, "t"),
        CpuExactBackend(cfg, init_now_s=10**10), 700,
    ))
    retries0 = metric_total("kta_segstore_retries_total")
    with FakeObjectStore(seg_dir, ignore_range=True) as store:
        got = run_scan(
            "t",
            SegmentFileSource(store.url, "t", fetch=fetch_cfg(0)),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
    assert scan_doc(got) == ref
    assert got.degraded_partitions == {}
    assert metric_total("kta_segstore_retries_total") - retries0 == 0
    snap = default_registry().snapshot()["kta_segstore_fallback_total"]
    # >= 1, not one-per-chunk: range-ignoring LATCHES on first detection,
    # so concurrent catalog opens may already ride the whole-object path.
    assert any(
        s["labels"].get("reason") == "range-ignored" and s["value"] >= 1
        for s in snap["samples"]
    )


def test_range_ignoring_store_latches_one_get_per_open(tmp_path):
    """Once a server is known to ignore Range headers, each catalog open
    costs ONE whole-object GET with the header/tail probes sliced locally
    — not a full download per probe (3x the archive over a catalog)."""
    from kafka_topic_analyzer_tpu_torch.io.segstore import ObjectSegmentStore

    _write_gappy_chunks(tmp_path)
    with FakeObjectStore(str(tmp_path), ignore_range=True) as store:
        seg_store = ObjectSegmentStore(
            store.url, fetch=fetch_cfg(0, cache=str(tmp_path / "cache"))
        )
        refs = seg_store.list_refs("gap")
        seg_store.open(refs[0])  # detects + latches mid-open
        assert seg_store.transport.range_ignored
        before = store.requests_served
        f1 = seg_store.open(refs[1])
        assert store.requests_served - before == 1
        assert f1.end_offset == 298  # locally-sliced tail, offset-exact
        # The whole-object probe SEEDED the cache: materializing the body
        # costs no additional GET — one wire crossing per chunk per scan.
        f1.ensure_body()
        assert store.requests_served - before == 1


def test_bucketless_spec_rejected():
    from kafka_topic_analyzer_tpu_torch.io.segstore import open_segment_store

    for spec in ("http://127.0.0.1:9000", "https://host/", "http://h:80//"):
        with pytest.raises(ValueError, match="no bucket"):
            open_segment_store(spec)


# ---------------------------------------------------------------------------
# corrupted fetches: classification + one-re-fetch disambiguation


def _as_dict_root(seg_dir):
    return {
        f: open(os.path.join(seg_dir, f), "rb").read()
        for f in os.listdir(seg_dir)
    }


def test_at_rest_corruption_classifies_after_one_refetch(seg_dir):
    objects = _as_dict_root(seg_dir)
    with FakeObjectStore(objects) as store:
        src = SegmentFileSource(store.url, "t", fetch=fetch_cfg(0))
        # Corrupt the OBJECT after the catalog validated its header: every
        # fetch now returns the same damaged bytes (ETag matches them, so
        # the MD5 check cannot save us — this is at-rest damage).
        data = bytearray(objects["t-1.ktaseg"])
        data[9] ^= 0xFF  # inside the header's partition field
        objects["t-1.ktaseg"] = bytes(data)
        refetches0 = metric_total("kta_corrupt_refetches_total")
        with pytest.raises(MalformedSegmentError) as e:
            for _ in src.batches(700):
                pass
        # Classified with the local reader's taxonomy + path context, and
        # the disambiguating re-fetch happened exactly once.
        assert e.value.kind == "malformed-header"
        assert "t-1.ktaseg" in str(e.value)
        assert metric_total("kta_corrupt_refetches_total") - refetches0 == 1
        assert store.body_gets["t-1.ktaseg"] == 2  # fetch + one re-fetch


def test_in_flight_corruption_is_healed_by_refetch(seg_dir):
    cfg = cpu_cfg()
    ref = scan_doc(run_scan(
        "t", SegmentFileSource(seg_dir, "t"),
        CpuExactBackend(cfg, init_now_s=10**10), 700,
    ))
    # (a) With ETags suppressed, a one-shot bit flip inside the header
    # region fails classification, and the ONE structural re-fetch heals
    # it — byte-identical scan, no corruption surfaced.
    with FakeObjectStore(seg_dir, send_etag=False) as store:
        store.script("t-0.ktaseg", ("flip", 9))
        got = run_scan(
            "t",
            SegmentFileSource(store.url, "t", fetch=fetch_cfg(0)),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
        assert scan_doc(got) == ref
        assert store.body_gets["t-0.ktaseg"] == 2
    # (b) With ETags on, the SAME flip anywhere in the body is caught by
    # the MD5 integrity check before classification ever runs, and
    # retried as a transient.
    retries0 = metric_total("kta_segstore_retries_total")
    with FakeObjectStore(seg_dir) as store:
        store.script("t-0.ktaseg", ("flip", 5000))
        got = run_scan(
            "t",
            SegmentFileSource(store.url, "t", fetch=fetch_cfg(0)),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
        assert scan_doc(got) == ref
    assert metric_total("kta_segstore_retries_total") - retries0 >= 1


# ---------------------------------------------------------------------------
# the local segment cache


def test_cache_cold_fills_warm_serves_byte_identical(seg_dir, tmp_path):
    cfg = cpu_cfg()
    cache = str(tmp_path / "cache")
    ref = scan_doc(run_scan(
        "t", SegmentFileSource(seg_dir, "t"),
        CpuExactBackend(cfg, init_now_s=10**10), 700,
    ))
    hits0 = metric_total("kta_segstore_cache_hits_total")
    misses0 = metric_total("kta_segstore_cache_misses_total")
    with FakeObjectStore(seg_dir) as store:
        for expect_body_gets in (3, 0):  # cold fetches all 3; warm none
            before = sum(store.body_gets.values())
            got = run_scan(
                "t",
                SegmentFileSource(
                    store.url, "t", fetch=fetch_cfg(2, cache=cache)
                ),
                CpuExactBackend(cfg, init_now_s=10**10), 700,
            )
            assert scan_doc(got) == ref
            assert (
                sum(store.body_gets.values()) - before == expect_body_gets
            )
    assert metric_total("kta_segstore_cache_misses_total") - misses0 == 3
    assert metric_total("kta_segstore_cache_hits_total") - hits0 == 3


def test_poisoned_cache_entry_refetched_never_served(seg_dir, tmp_path):
    cfg = cpu_cfg()
    cache = str(tmp_path / "cache")
    ref = scan_doc(run_scan(
        "t", SegmentFileSource(seg_dir, "t"),
        CpuExactBackend(cfg, init_now_s=10**10), 700,
    ))
    with FakeObjectStore(seg_dir) as store:
        fetch = fetch_cfg(2, cache=cache)
        run_scan(
            "t", SegmentFileSource(store.url, "t", fetch=fetch),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
        # Flip one byte inside a cached entry (bit rot at rest in the
        # cache itself — NOT in the store).
        entry = sorted(
            f for f in os.listdir(cache) if f.endswith(".seg")
        )[0]
        path = os.path.join(cache, entry)
        data = bytearray(open(path, "rb").read())
        data[4321] ^= 0x10
        open(path, "wb").write(bytes(data))
        before = sum(store.body_gets.values())
        poisoned0 = metric_total("kta_segstore_fallback_total")
        got = run_scan(
            "t", SegmentFileSource(store.url, "t", fetch=fetch),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
        # Detected, booked, re-fetched — and the results never saw the
        # flipped bytes.
        assert scan_doc(got) == ref
        assert sum(store.body_gets.values()) - before == 1
        assert metric_total("kta_segstore_fallback_total") - poisoned0 == 1
        snap = default_registry().snapshot()["kta_segstore_fallback_total"]
        assert any(
            s["labels"].get("reason") == "cache-poisoned" and s["value"] >= 1
            for s in snap["samples"]
        )


def test_stale_cache_entry_is_miss_not_corruption(seg_dir, tmp_path):
    """An entry that matches its OWN sha256 sidecar but no longer matches
    the catalog's header (the archive was re-dumped at the same name and
    size) must be evicted and re-fetched — never classified as fatal
    corruption."""
    import struct

    cfg = cpu_cfg()
    cache = str(tmp_path / "cache")
    objects = _as_dict_root(seg_dir)
    with FakeObjectStore(objects) as store:
        fetch = fetch_cfg(0, cache=cache)
        run_scan(
            "t", SegmentFileSource(store.url, "t", fetch=fetch),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
        # Re-dump the archive: same names/sizes, start offsets shifted
        # (the header changes, the sidecar-verified cache entries do not).
        for name in list(objects):
            data = bytearray(objects[name])
            data[16:24] = struct.pack("<q", 500)  # start_offset
            objects[name] = bytes(data)
        stale0 = metric_total("kta_segstore_fallback_total")
        got = run_scan(
            "t", SegmentFileSource(store.url, "t", fetch=fetch),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
        # The NEW dump's offsets — fresh bytes, not the stale entries.
        assert got.start_offsets == {0: 500, 1: 500, 2: 500}
        assert got.degraded_partitions == {}
        assert metric_total("kta_segstore_fallback_total") - stale0 == 3
        snap = default_registry().snapshot()["kta_segstore_fallback_total"]
        assert any(
            s["labels"].get("reason") == "cache-stale" and s["value"] >= 3
            for s in snap["samples"]
        )
        # And the re-dump is now cached: a third scan hits, no body GETs.
        before = sum(store.body_gets.values())
        run_scan(
            "t", SegmentFileSource(store.url, "t", fetch=fetch),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
        assert sum(store.body_gets.values()) == before


def test_cache_reinsert_does_not_double_count(tmp_path):
    """Re-inserting an existing digest replaces its bytes: the running
    resident-bytes estimate must grow by the NET change only, or racing
    fetches of one chunk inflate it and trigger premature full-directory
    eviction sweeps."""
    from kafka_topic_analyzer_tpu_torch.io.objstore import SegmentCache

    cache = SegmentCache(str(tmp_path / "c"), 100, "store")
    cache.put("a", 60, b"x" * 60)
    cache.put("a", 60, b"x" * 60)
    assert cache._total == 60
    # A second distinct entry fits the bound exactly — no sweep runs.
    evict0 = metric_total("kta_segstore_cache_evictions_total")
    cache.put("b", 30, b"y" * 30)
    assert cache._total == 90
    assert metric_total("kta_segstore_cache_evictions_total") == evict0
    resident = [
        f for f in os.listdir(str(tmp_path / "c")) if f.endswith(".seg")
    ]
    assert len(resident) == 2


def test_cache_lru_eviction_bounds_directory(seg_dir, tmp_path):
    cfg = cpu_cfg()
    cache = str(tmp_path / "cache")
    sizes = {
        f: os.path.getsize(os.path.join(seg_dir, f))
        for f in os.listdir(seg_dir)
    }
    # Bound below two chunks: after every insert the LRU sweep keeps the
    # newest entry and evicts back under the bound.
    bound = max(sizes.values()) + 10
    evict0 = metric_total("kta_segstore_cache_evictions_total")
    with FakeObjectStore(seg_dir) as store:
        fetch = SegmentFetchConfig(
            readahead=0, cache_dir=cache, cache_max_bytes=bound,
            retry=FAST_RETRY, timeout_s=5,
        )
        run_scan(
            "t", SegmentFileSource(store.url, "t", fetch=fetch),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
    resident = sum(
        os.path.getsize(os.path.join(cache, f))
        for f in os.listdir(cache) if f.endswith(".seg")
    )
    assert resident <= bound
    assert metric_total("kta_segstore_cache_evictions_total") - evict0 >= 2


# ---------------------------------------------------------------------------
# cross-store resume


class _Interrupt(Exception):
    pass


class _InterruptingSegSource(SegmentFileSource):
    """Raises after yielding `limit` batches on the initial pass (resume
    passes — start_at set — run to completion)."""

    def __init__(self, *a, limit=2, **kw):
        super().__init__(*a, **kw)
        self.limit = limit

    def batches(self, batch_size, partitions=None, start_at=None, sink=None):
        it = super().batches(batch_size, partitions, start_at, sink=sink)
        for i, b in enumerate(it):
            if start_at is None and i >= self.limit:
                raise _Interrupt()
            yield b


def test_cross_store_resume_both_directions(seg_dir, tmp_path):
    from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend

    cfg = cpu_cfg(batch_size=512)
    ref = scan_doc(run_scan(
        "t", SegmentFileSource(seg_dir, "t"),
        TorchBackend(cfg, device="cpu", init_now_s=77), 512,
    ))
    with FakeObjectStore(seg_dir) as store:
        def remote_src(interrupting=False, **kw):
            cls = _InterruptingSegSource if interrupting else SegmentFileSource
            return cls(store.url, "t", fetch=fetch_cfg(2), **kw)

        # local snapshot → remote completion
        snap1 = str(tmp_path / "snap1")
        with pytest.raises(_Interrupt):
            run_scan(
                "t",
                _InterruptingSegSource(seg_dir, "t", limit=2),
                TorchBackend(cfg, device="cpu", init_now_s=77), 512,
                snapshot_dir=snap1, snapshot_every_s=0.0,
            )
        got = run_scan(
            "t", remote_src(), TorchBackend(cfg, device="cpu", init_now_s=0), 512,
            snapshot_dir=snap1, resume=True,
        )
        assert scan_doc(got) == ref

        # remote snapshot → local completion
        snap2 = str(tmp_path / "snap2")
        with pytest.raises(_Interrupt):
            run_scan(
                "t", remote_src(interrupting=True, limit=2),
                TorchBackend(cfg, device="cpu", init_now_s=77), 512,
                snapshot_dir=snap2, snapshot_every_s=0.0,
            )
        got = run_scan(
            "t", SegmentFileSource(seg_dir, "t"),
            TorchBackend(cfg, device="cpu", init_now_s=0), 512,
            snapshot_dir=snap2, resume=True,
        )
        assert scan_doc(got) == ref


# ---------------------------------------------------------------------------
# CLI e2e + unsupported-combination errors


def test_cli_remote_scan_json_with_cache_and_digest(seg_dir, tmp_path, capsys):
    from kafka_topic_analyzer_tpu_torch.cli import main
    from kafka_topic_analyzer_tpu_torch.results import SegmentStats

    cache = str(tmp_path / "cache")
    before = SegmentStats.from_telemetry(default_registry().snapshot())
    with FakeObjectStore(seg_dir) as store:
        assert main([
            "-t", "t", "--source", "segfile", "--segment-dir", store.url,
            "--segment-readahead", "2", "--segment-cache", cache,
            "--backend", "cpu", "-c", "--alive-bitmap-bits", "18",
            "--batch-size", "700", "--json", "--quiet", "--native", "off",
        ]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["overall"]["count"] == 3 * SPEC.messages_per_partition
        seg = doc["segments"]
        # The remote-tier block rides the segments digest (deltas: the
        # registry is cumulative under pytest).
        assert seg["store_gets"] - before.gets >= 4  # list + headers + bodies
        assert seg["store_bytes_fetched"] > before.bytes_fetched
        assert seg["cache_misses"] - before.cache_misses == 3
        assert "kta_segstore_gets_total" in doc["telemetry"]
        assert os.path.isdir(cache)


def test_cli_degraded_remote_scan_exits_3(seg_dir, capsys):
    from kafka_topic_analyzer_tpu_torch.cli import EXIT_DEGRADED, main

    with FakeObjectStore(seg_dir) as store:
        store.script("t-2.ktaseg", *[("status", 503)] * 32)
        # The remote tier honors the wire scan's retry knobs through the
        # same --librdkafka spellings — shrink the schedule so budget
        # exhaustion is fast.
        rc = main([
            "-t", "t", "--source", "segfile", "--segment-dir", store.url,
            "--segment-readahead", "0", "--backend", "cpu",
            "--librdkafka",
            "retry.backoff.ms=1,reconnect.backoff.max.ms=4,"
            "transport.retry.budget=3",
            "--batch-size", "700", "--quiet", "--native", "off",
        ])
    assert rc == EXIT_DEGRADED
    out = capsys.readouterr().out
    assert "DEGRADED" in out


def test_segment_cache_requires_segfile(capsys):
    from kafka_topic_analyzer_tpu_torch.cli import main

    rc = main([
        "-t", "t", "--source", "kafka", "-b", "127.0.0.1:9",
        "--segment-cache", "/tmp/nope", "--quiet",
    ])
    assert rc == 1
    assert "--segment-cache requires --source segfile" in (
        capsys.readouterr().err
    )


def test_segment_dir_error_mentions_remote_specs(capsys):
    from kafka_topic_analyzer_tpu_torch.cli import main

    with pytest.raises(SystemExit) as e:
        main(["-t", "t", "--source", "segfile", "--quiet"])
    msg = str(e.value)
    assert "http(s)://" in msg and "s3://" in msg


# ---------------------------------------------------------------------------
# bench smoke


def test_bench_segments_remote_smoke(capsys):
    from kafka_topic_analyzer_tpu_torch.tools.bench_segments import main as bench

    assert bench([
        "--records", "8000", "--partitions", "2", "--chunk-records", "2000",
        "--workers", "2", "--store", "serve", "--inject-latency-ms", "1",
        "--readahead", "0,2", "--repeat", "1", "--native", "off",
    ]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["store"] == "serve"
    assert set(doc["seg_msgs_per_sec"]) == {"w2.ra0", "w2.ra2"}
    assert all(v > 0 for v in doc["seg_msgs_per_sec"].values())


# ---------------------------------------------------------------------------
# the port against the reference


def _drop_timing(text: str) -> str:
    return "".join(
        line for line in text.splitlines(keepends=True)
        if not line.startswith(("Scanning took:", "Estimated Msg/s:"))
    )


@pytest.mark.parametrize(
    "extra",
    [{}, {"wire_format": 4}, {"alive_compaction": "off"}],
    ids=["v5", "v4", "compaction-off"],
)
def test_remote_report_equals_the_reference_remote_scan(seg_dir, extra):
    """The port's client and server against the reference's client and
    server over the same chunks: the same report, and both equal the
    local scan."""
    from fake_objstore import FakeObjectStore as RefFakeObjectStore
    from kafka_topic_analyzer_tpu.backends.tpu import TpuBackend as RefBackend
    from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefConfig
    from kafka_topic_analyzer_tpu.config import SegmentFetchConfig as RefFetch
    from kafka_topic_analyzer_tpu.config import TransportRetryConfig as RefRetry
    from kafka_topic_analyzer_tpu.engine import run_scan as ref_run_scan
    from kafka_topic_analyzer_tpu.io.segfile import SegmentFileSource as RefSource
    from kafka_topic_analyzer_tpu.report import render_report as ref_render
    from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
    from kafka_topic_analyzer_tpu_torch.report import render_report

    kw = dict(num_partitions=3, batch_size=512, count_alive_keys=True,
              alive_bitmap_bits=18, distinct_keys_per_partition=True,
              hll_p=8, quantiles_per_partition=True, **extra)

    def text(render, r):
        return _drop_timing(render("t", r.metrics, r.start_offsets,
                                   r.end_offsets, 0, show_alive_keys=True))

    with RefFakeObjectStore(seg_dir) as ref_store:
        ref = ref_run_scan(
            "t",
            RefSource(ref_store.url, "t", fetch=RefFetch(
                readahead=2, retry=RefRetry(backoff_ms=1, backoff_max_ms=4,
                                            retry_budget=4))),
            RefBackend(RefConfig(**kw), init_now_s=10**10), 512,
        )
    local = run_scan("t", SegmentFileSource(seg_dir, "t"),
                     TorchBackend(AnalyzerConfig(**kw), init_now_s=10**10,
                                  device="cpu"), 512)
    with FakeObjectStore(seg_dir) as store:
        got = run_scan(
            "t", SegmentFileSource(store.url, "t", fetch=fetch_cfg(2)),
            TorchBackend(AnalyzerConfig(**kw), init_now_s=10**10, device="cpu"),
            512, ingest_workers=2,
        )
    assert text(render_report, got) == text(ref_render, ref)
    assert text(render_report, got) == text(render_report, local)
    assert scan_doc(got) == scan_doc(local)


def test_cli_remote_report_equals_the_reference_cli(seg_dir, capsys):
    """Both CLIs over the port's server: the same stdout, timing aside."""
    from kafka_topic_analyzer_tpu import cli as ref_cli
    from kafka_topic_analyzer_tpu_torch import cli

    with FakeObjectStore(seg_dir) as store:
        args = ["-t", "t", "--source", "segfile", "--segment-dir", store.url,
                "-c", "--alive-bitmap-bits", "20", "--batch-size", "512",
                "--distinct-keys", "--quantiles", "--quiet"]
        assert ref_cli.main(args + ["--backend", "tpu"]) == 0
        ref = capsys.readouterr().out
        assert cli.main(args + ["--device", "cpu", "--superbatch", "2",
                                "--ingest-workers", "2"]) == 0
        got = capsys.readouterr().out
    assert _drop_timing(got) == _drop_timing(ref)


def test_fetch_fault_degrades_exits_3_and_resume_completes(seg_dir, tmp_path, capsys):
    """An unreachable chunk (its retry budget spent) makes its partition
    DEGRADED: exit 3, the DEGRADED block, and a snapshot on disk that a
    ``--resume`` against the healed store completes into the full
    scan's report."""
    from kafka_topic_analyzer_tpu_torch.cli import EXIT_DEGRADED, main

    snap = str(tmp_path / "snap")
    base = ["-t", "t", "--source", "segfile", "-c", "--alive-bitmap-bits",
            "18", "--batch-size", "700", "--device", "cpu", "--quiet",
            "--segment-readahead", "0", "--snapshot-dir", snap,
            "--librdkafka", "retry.backoff.ms=1,reconnect.backoff.max.ms=4,"
            "transport.retry.budget=3"]
    assert main(base[:-4] + ["--segment-dir", seg_dir]) == 0
    full = capsys.readouterr().out  # local, no snapshot (base[:-4])
    with FakeObjectStore(seg_dir) as store:
        store.script("t-1.ktaseg", *[("status", 503)] * 32)
        rc = main(base + ["--segment-dir", store.url])
        out = capsys.readouterr().out
        assert rc == EXIT_DEGRADED
        assert "DEGRADED" in out
        assert os.path.exists(os.path.join(snap, "scan_snapshot.npz"))
        store._scripts.clear()
        assert main(base + ["--segment-dir", store.url, "--resume"]) == 0
        resumed = capsys.readouterr().out
    assert _drop_timing(resumed) == _drop_timing(full)


def test_warm_cache_hit_is_a_read_only_map_that_packs_without_a_copy(seg_dir, tmp_path):
    """A verified cache hit arrives as a read-only ``np.memmap``: its
    column views share the mapping's memory, ``pack_batch(out=)`` packs
    straight from them, and a fused (native) torch scan of the warm cache
    equals the local scan."""
    from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
    from kafka_topic_analyzer_tpu_torch.io import native
    from kafka_topic_analyzer_tpu_torch.io.segfile import RemoteSegmentFile
    from kafka_topic_analyzer_tpu_torch.packing import pack_batch, packed_nbytes

    cache = str(tmp_path / "cache")
    cfg = cpu_cfg(batch_size=512)
    local = scan_doc(run_scan("t", SegmentFileSource(seg_dir, "t"),
                              TorchBackend(cfg, init_now_s=10**10, device="cpu"), 512))
    with FakeObjectStore(seg_dir) as store:
        fetch = fetch_cfg(0, cache=cache)
        run_scan("t", SegmentFileSource(store.url, "t", fetch=fetch),
                 CpuExactBackend(cfg, init_now_s=10**10), 512)
        before = sum(store.body_gets.values())
        src = SegmentFileSource(store.url, "t", fetch=fetch)
        seg = src.segments[0][0]
        assert isinstance(seg, RemoteSegmentFile)
        body = seg.ensure_body()
        assert isinstance(body, np.memmap) and not body.flags.writeable
        batch = seg.read_batch(0, 512)
        assert np.shares_memory(batch.key_len, body)
        out = np.empty(packed_nbytes(cfg, 512), dtype=np.uint8)
        assert pack_batch(batch, cfg, out=out) is out
        assert (out == pack_batch(seg.read_batch(0, 512, copy=True), cfg)).all()
        seg.release()
        backend = TorchBackend(cfg, init_now_s=10**10, device="cpu",
                               use_native=native.native_available())
        got = run_scan("t", SegmentFileSource(store.url, "t", fetch=fetch),
                       backend, 512)
        assert sum(store.body_gets.values()) == before  # all served warm
    assert got.fused == native.native_available()
    assert scan_doc(got) == local
