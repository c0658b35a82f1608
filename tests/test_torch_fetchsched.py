"""The port's process-wide fetch scheduler (``io/fetchsched.py``) and the
verify-amortized cache, held to the reference's tests: per-stream
fairness (weighted), demand-over-speculative reordering, bounded queue
memory, clean shutdown mid-fetch, the trust latch (one sha256 per entry
per process, poison still caught on first touch), and remote scans that
equal local scans at any fetch concurrency, readahead depth or cache
state — through the port's own object-store server.  The scheduler
grows with the resolved ingest-stream count.
"""

import os
import threading
import time

import pytest
from test_torch_objstore import PortFakeObjectStore as FakeObjectStore

from kafka_topic_analyzer_tpu_torch.backends.cpu import CpuExactBackend
from kafka_topic_analyzer_tpu_torch.config import (
    AnalyzerConfig,
    SegmentFetchConfig,
    TransportRetryConfig,
)
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu.io import fetchsched as ref_fetchsched
from kafka_topic_analyzer_tpu_torch.io import fetchsched
from kafka_topic_analyzer_tpu_torch.io.fetchsched import (
    FetchScheduler,
    default_concurrency,
)
from kafka_topic_analyzer_tpu_torch.io.segfile import (
    SegmentFileSource,
    write_segment_from_batches,
)
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry

pytestmark = pytest.mark.fetchsched

SPEC = SyntheticSpec(
    num_partitions=3,
    messages_per_partition=2_000,
    keys_per_partition=90,
    tombstone_permille=130,
    seed=11,
)
FAST_RETRY = TransportRetryConfig(
    backoff_ms=1, backoff_max_ms=4, retry_budget=4
)


def fetch_cfg(readahead=2, cache=None, fc="auto"):
    return SegmentFetchConfig(
        readahead=readahead, cache_dir=cache, retry=FAST_RETRY,
        timeout_s=5.0, fetch_concurrency=fc,
    )


@pytest.fixture(autouse=True)
def _fresh_scheduler():
    """Every test starts (and leaves) the process with NO singleton and
    no remembered --fetch-concurrency: the latch/pool state under test is
    deliberately process-global."""
    fetchsched._reset_for_tests()
    yield
    fetchsched._reset_for_tests()


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


def metric_total(name, **labels):
    m = default_registry().snapshot().get(name)
    if not m:
        return 0.0
    return sum(
        s["value"] for s in m["samples"]
        if all(s["labels"].get(k) == v for k, v in labels.items())
    )


class _Gate:
    """A fetch that parks its worker until released — the deterministic
    way to build up a queue behind a busy pool."""

    def __init__(self, tag="gate", order=None):
        self.tag = tag
        self.order = order
        self.started = threading.Event()
        self.release = threading.Event()

    def __call__(self):
        self.started.set()
        assert self.release.wait(10), "gate never released"
        if self.order is not None:
            self.order.append(self.tag)
        return self.tag


def _recorder(tag, order, lock):
    def fn():
        with lock:
            order.append(tag)
        return tag
    return fn


# ---------------------------------------------------------------------------
# scheduler units


def test_configuration_explicit_beats_auto_hints():
    assert SegmentFetchConfig.parse(
        fetch_concurrency="8"
    ).resolve_concurrency() == 8
    assert SegmentFetchConfig.parse(
        fetch_concurrency="auto"
    ).resolve_concurrency() is None
    with pytest.raises(ValueError, match="fetch.concurrency|fetch-concurrency"):
        SegmentFetchConfig.parse(fetch_concurrency="0")
    with pytest.raises(ValueError, match="fetch-concurrency"):
        SegmentFetchConfig.parse(fetch_concurrency="many")
    # Explicit flag sizes the singleton; later auto hints never override.
    fetchsched.configure(3, explicit=True)
    fetchsched.note_streams(64)
    assert fetchsched.get_scheduler().concurrency == 3
    fetchsched._reset_for_tests()
    # Under auto, stream hints grow the pool (capped), never shrink it.
    fetchsched.note_streams(1)
    base = fetchsched.get_scheduler().concurrency
    assert base == default_concurrency()
    fetchsched.note_streams(64)
    assert fetchsched.get_scheduler().concurrency == 16


def test_fairness_deep_backlog_cannot_starve_a_sibling_stream():
    """Round-robin across streams: stream B's FIRST request is served
    after at most one of stream A's, no matter how deep A's speculative
    backlog is (two fleet topics share one pool without stalls)."""
    sched = FetchScheduler(1)
    order, lock = [], threading.Lock()
    try:
        g, a, b = sched.stream(), sched.stream(), sched.stream()
        gate = _Gate(order=order)
        g.submit(gate, speculative=False)
        assert gate.started.wait(5)
        tickets = [
            a.submit(_recorder(f"a{i}", order, lock), seq=i)
            for i in range(5)
        ]
        tickets.append(b.submit(_recorder("b0", order, lock), seq=0))
        gate.release.set()
        for t in tickets:
            assert t.wait(10)
        assert order[0] == "gate"
        assert order.index("b0") <= 2, order
        # Within stream A, chunks still ran in plan order.
        a_done = [x for x in order if x.startswith("a")]
        assert a_done == sorted(a_done)
    finally:
        sched.shutdown()


def test_weighted_fairness_share_matches_weights():
    """Smooth weighted round-robin: a stream carrying 3× the partitions
    gets 3× the picks — deterministically interleaved (never 3 in a
    burst then 1), so the light stream's latency stays bounded."""
    sched = FetchScheduler(1)
    order, lock = [], threading.Lock()
    try:
        g = sched.stream()
        a = sched.stream(weight=3.0)
        b = sched.stream(weight=1.0)
        gate = _Gate(order=order)
        g.submit(gate, speculative=False)
        assert gate.started.wait(5)
        tickets = [
            a.submit(_recorder(f"a{i}", order, lock), seq=i)
            for i in range(6)
        ] + [
            b.submit(_recorder(f"b{i}", order, lock), seq=i)
            for i in range(2)
        ]
        gate.release.set()
        for t in tickets:
            assert t.wait(10)
        served = order[1:]  # drop the gate
        # First full weight cycle (4 picks): 3 of A, 1 of B — and the
        # smooth property: B is served INSIDE the cycle, not appended.
        assert sum(1 for x in served[:4] if x.startswith("a")) == 3
        assert sum(1 for x in served[:4] if x.startswith("b")) == 1
        # Whole run honours the 3:1 share and per-stream plan order.
        for s in ("a", "b"):
            got = [x for x in served if x.startswith(s)]
            assert got == sorted(got)
    finally:
        sched.shutdown()


def test_set_weight_rebalances_a_live_stream():
    """set_weight() takes effect on the next pick: a stream that starts
    equal and then declares a heavier plan immediately earns the larger
    share (segfile registers its plan size on first schedule())."""
    sched = FetchScheduler(1)
    order, lock = [], threading.Lock()
    try:
        g, a, b = sched.stream(), sched.stream(), sched.stream()
        a.set_weight(5.0)
        gate = _Gate(order=order)
        g.submit(gate, speculative=False)
        assert gate.started.wait(5)
        tickets = [
            a.submit(_recorder(f"a{i}", order, lock), seq=i)
            for i in range(5)
        ] + [
            b.submit(_recorder(f"b{i}", order, lock), seq=i)
            for i in range(2)
        ]
        gate.release.set()
        for t in tickets:
            assert t.wait(10)
        served = order[1:]
        # One full cycle of 6 picks carries 5 of A and 1 of B.
        assert sum(1 for x in served[:6] if x.startswith("a")) == 5
        with pytest.raises(ValueError):
            a.set_weight(0.0)
    finally:
        sched.shutdown()


def test_equal_weights_are_exact_round_robin():
    """The SWRR degenerate case: every weight 1.0 alternates strictly in
    registration order — the pre-weight fairness contract, unchanged."""
    sched = FetchScheduler(1)
    order, lock = [], threading.Lock()
    try:
        g, a, b = sched.stream(), sched.stream(), sched.stream()
        gate = _Gate(order=order)
        g.submit(gate, speculative=False)
        assert gate.started.wait(5)
        tickets = [
            a.submit(_recorder(f"a{i}", order, lock), seq=i)
            for i in range(3)
        ] + [
            b.submit(_recorder(f"b{i}", order, lock), seq=i)
            for i in range(3)
        ]
        gate.release.set()
        for t in tickets:
            assert t.wait(10)
        assert order[1:] == ["a0", "b0", "a1", "b1", "a2", "b2"]
    finally:
        sched.shutdown()


def test_weighted_remote_scan_stays_byte_identical(seg_dir):
    """Weights change WHO is picked next, never WHAT is read: a remote
    scan through auto-weighted streams (segfile registers plan sizes)
    matches the local referee byte for byte."""
    local = scan_doc(
        run_scan(
            "t", SegmentFileSource(seg_dir, "t"),
            CpuExactBackend(cpu_cfg(), init_now_s=10**10), 700,
        )
    )
    with FakeObjectStore(seg_dir) as store:
        remote = scan_doc(
            run_scan(
                "t",
                SegmentFileSource(
                    store.url, "t", fetch=fetch_cfg(readahead=3, fc=2),
                ),
                CpuExactBackend(cpu_cfg(), init_now_s=10**10), 700,
            )
        )
    assert remote == local


def test_deadline_promotion_jumps_demand_past_speculation():
    """The deadline rule: promoting a queued speculative request to
    DEMAND books {deadline-promotion}, and serving it ahead of
    earlier-submitted speculation books {demand-over-speculative}."""
    promo0 = metric_total(
        "kta_fetch_sched_reorders_total", reason="deadline-promotion"
    )
    jump0 = metric_total(
        "kta_fetch_sched_reorders_total", reason="demand-over-speculative"
    )
    sched = FetchScheduler(1)
    order, lock = [], threading.Lock()
    try:
        g, a = sched.stream(), sched.stream()
        gate = _Gate(order=order)
        g.submit(gate, speculative=False)
        assert gate.started.wait(5)
        tickets = [
            a.submit(_recorder(f"s{i}", order, lock), seq=i)
            for i in range(3)
        ]
        # The consumer reached chunk 2 while its request was still
        # queued read-ahead: promote it past s0/s1.
        assert sched.promote(tickets[2])
        gate.release.set()
        for t in tickets:
            assert t.wait(10)
        assert order == ["gate", "s2", "s0", "s1"]
        assert metric_total(
            "kta_fetch_sched_reorders_total", reason="deadline-promotion"
        ) - promo0 == 1
        assert metric_total(
            "kta_fetch_sched_reorders_total", reason="demand-over-speculative"
        ) - jump0 >= 1
        # Promotion is a QUEUED-only transition: done tickets refuse.
        assert not sched.promote(tickets[0])
    finally:
        sched.shutdown()


def test_occupancy_gauges_track_queue_and_inflight_then_settle():
    q0 = metric_total("kta_fetch_sched_queue_depth")
    f0 = metric_total("kta_fetch_sched_inflight")
    wait0 = metric_total("kta_fetch_sched_wait_seconds_total")
    sched = FetchScheduler(2)
    try:
        s = sched.stream()
        gates = [_Gate(f"g{i}") for i in range(2)]
        gate_tickets = [s.submit(g, speculative=False) for g in gates]
        for g in gates:
            assert g.started.wait(5)
        queued = [s.submit(lambda: None, seq=i) for i in range(8)]
        assert metric_total("kta_fetch_sched_queue_depth") - q0 == 8
        assert metric_total("kta_fetch_sched_inflight") - f0 == 2
        for g in gates:
            g.release.set()
        for t in gate_tickets + queued:
            assert t.wait(10)
        assert metric_total("kta_fetch_sched_queue_depth") - q0 == 0
        assert metric_total("kta_fetch_sched_inflight") - f0 == 0
        # The queued requests sat behind the gates: wait time was booked.
        assert metric_total("kta_fetch_sched_wait_seconds_total") > wait0
    finally:
        sched.shutdown()


def test_clean_shutdown_mid_fetch_cancels_queued_drains_inflight():
    c0 = metric_total("kta_fetch_sched_cancelled_total")
    q0 = metric_total("kta_fetch_sched_queue_depth")
    sched = FetchScheduler(1)
    s = sched.stream()
    gate = _Gate()
    gate_ticket = s.submit(gate, speculative=False)
    assert gate.started.wait(5)
    queued = [s.submit(lambda: None, seq=i) for i in range(3)]
    joiner = threading.Thread(target=sched.shutdown, kwargs={"wait": True})
    joiner.start()
    # Queued requests are cancelled immediately (booked), even while the
    # in-flight fetch is still on its worker...
    for t in queued:
        assert t.wait(10) and t.cancelled
    assert metric_total("kta_fetch_sched_cancelled_total") - c0 == 3
    assert gate_ticket.state != 3  # the in-flight fetch was NOT cancelled
    # ...and the in-flight fetch completes cleanly, then workers exit.
    gate.release.set()
    joiner.join(timeout=10)
    assert not joiner.is_alive()
    assert gate_ticket.result() == "gate"
    assert metric_total("kta_fetch_sched_queue_depth") - q0 == 0
    with pytest.raises(RuntimeError, match="shut down"):
        sched.stream()


def test_errors_are_redelivered_to_the_waiter_run_all_is_atomic():
    sched = FetchScheduler(2)
    try:
        def boom():
            raise OSError("wire fell over")

        with pytest.raises(OSError, match="wire fell over"):
            sched.run(boom)
        assert sched.run(lambda: 41) == 41
        # run_all: results in submission order; the FIRST failure by
        # order is re-raised only after every request settled.
        settled = threading.Event()

        def late_ok():
            assert settled.wait(10)
            return "late"

        def fail_then_release():
            settled.set()
            raise ValueError("first by order")

        with pytest.raises(ValueError, match="first by order"):
            sched.run_all([fail_then_release, late_ok])
        assert sched.run_all([lambda: 1, lambda: 2, lambda: 3]) == [1, 2, 3]
    finally:
        sched.shutdown()


def test_release_cancels_a_scheduled_fetch_that_never_started(seg_dir):
    """Satellite: RemoteSegmentFile.release() cancels its not-yet-started
    scheduler request (booked) — degraded-skip/teardown paths must not
    pay for bytes nobody will read."""
    from kafka_topic_analyzer_tpu_torch.io.segfile import (
        HEADER_SIZE,
        RemoteSegmentFile,
    )

    chunk = sorted(
        f for f in os.listdir(seg_dir) if f.endswith(".ktaseg")
    )[0]
    path = os.path.join(seg_dir, chunk)
    raw = open(path, "rb").read()
    seg = RemoteSegmentFile(
        lambda validate: raw, chunk, "mem://", len(raw), raw[:HEADER_SIZE]
    )
    c0 = metric_total("kta_fetch_sched_cancelled_total")
    sched = FetchScheduler(1)
    try:
        s = sched.stream()
        gate = _Gate()
        s.submit(gate, speculative=False)
        assert gate.started.wait(5)
        seg._pending = s.submit(seg.ensure_body, seq=7)
        pending = seg._pending
        seg.release()
        assert pending.cancelled
        assert seg._pending is None
        assert metric_total("kta_fetch_sched_cancelled_total") - c0 == 1
        gate.release.set()
    finally:
        sched.shutdown()
    # A later touch still fetches fine — cancellation dropped read-ahead,
    # not the chunk.
    assert seg.ensure_body().nbytes == len(raw)


# ---------------------------------------------------------------------------
# remote-vs-local byte-identity across the concurrency surface


def test_remote_byte_identity_workers_x_superbatch_x_readahead(seg_dir):
    """The workers × K × readahead matrix run through the ONE shared scheduler, at a
    deliberately tiny pool (--fetch-concurrency 2) so demand and
    speculation genuinely queue: workers × K × readahead must stay
    byte-identical to the local referee."""
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
                            store.url, "t",
                            fetch=fetch_cfg(readahead, fc=2),
                        ),
                        backend, 256, ingest_workers=workers,
                    )
                    assert got.superbatch_k == k
                    assert scan_doc(got) == ref, (workers, k, readahead)
        assert fetchsched.get_scheduler().concurrency == 2
    # Everything drained and settled: every occupancy gauge back at zero.
    assert metric_total("kta_segstore_readahead_occupancy") == 0
    assert metric_total("kta_fetch_sched_queue_depth") == 0
    assert metric_total("kta_fetch_sched_inflight") == 0


def test_remote_byte_identity_across_fetch_concurrency(seg_dir):
    cfg = cpu_cfg()
    ref = scan_doc(run_scan(
        "t", SegmentFileSource(seg_dir, "t"),
        CpuExactBackend(cfg, init_now_s=10**10), 700,
    ))
    with FakeObjectStore(seg_dir) as store:
        for fc in (1, "auto"):
            fetchsched._reset_for_tests()
            got = run_scan(
                "t",
                SegmentFileSource(
                    store.url, "t", fetch=fetch_cfg(2, fc=fc)
                ),
                CpuExactBackend(cfg, init_now_s=10**10), 700,
                ingest_workers=4,
            )
            assert scan_doc(got) == ref, fc


def test_readahead_window_bounds_outstanding_chunks(seg_dir):
    """Memory bound: the shared pool never holds more than
    streams × (readahead + 1) fetched-but-unconsumed chunks — sampled
    through the occupancy gauge across a latency-injected scan."""
    cfg = cpu_cfg()
    peak, stop = [0.0], threading.Event()

    def sampler():
        while not stop.is_set():
            peak[0] = max(
                peak[0], metric_total("kta_segstore_readahead_occupancy")
            )
            time.sleep(0.0005)

    th = threading.Thread(target=sampler)
    th.start()
    try:
        with FakeObjectStore(seg_dir, latency_ms=5) as store:
            got = run_scan(
                "t",
                SegmentFileSource(store.url, "t", fetch=fetch_cfg(2)),
                CpuExactBackend(cfg, init_now_s=10**10), 700,
                ingest_workers=2,
            )
    finally:
        stop.set()
        th.join()
    assert got.ingest_workers == 2
    assert 0 < peak[0] <= 2 * (2 + 1)
    assert metric_total("kta_segstore_readahead_occupancy") == 0


# ---------------------------------------------------------------------------
# the verify-amortized cache (trust latch)


def test_latched_hit_skips_hashing_first_touch_still_verifies(
    seg_dir, tmp_path
):
    cfg = cpu_cfg()
    cache = str(tmp_path / "cache")
    ref = scan_doc(run_scan(
        "t", SegmentFileSource(seg_dir, "t"),
        CpuExactBackend(cfg, init_now_s=10**10), 700,
    ))
    with FakeObjectStore(seg_dir) as store:
        fetch = fetch_cfg(2, cache=cache)
        # Cold: fills the cache (put does NOT latch — trust is only ever
        # granted by a verifying read).
        run_scan(
            "t", SegmentFileSource(store.url, "t", fetch=fetch),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
        latched0 = metric_total("kta_segstore_cache_verify_latched_total")
        # Warm #1: every hit re-hashes (first touch this process) and
        # latches.
        verify0 = metric_total("kta_segstore_cache_verify_seconds_total")
        got = run_scan(
            "t", SegmentFileSource(store.url, "t", fetch=fetch),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
        assert scan_doc(got) == ref
        assert metric_total(
            "kta_segstore_cache_verify_seconds_total"
        ) > verify0
        assert metric_total(
            "kta_segstore_cache_verify_latched_total"
        ) == latched0
        # Warm #2: all three hits ride the latch — ZERO hashing seconds
        # booked, the latched-hit counter advances instead.
        verify1 = metric_total("kta_segstore_cache_verify_seconds_total")
        before = sum(store.body_gets.values())
        got = run_scan(
            "t", SegmentFileSource(store.url, "t", fetch=fetch),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
        assert scan_doc(got) == ref
        assert sum(store.body_gets.values()) == before
        assert metric_total(
            "kta_segstore_cache_verify_seconds_total"
        ) == verify1
        assert metric_total(
            "kta_segstore_cache_verify_latched_total"
        ) - latched0 == 3


def test_first_touch_poison_still_evicted_and_booked(seg_dir, tmp_path):
    """The never-serve-poison guarantee survives amortization: bytes that rotted in
    the cache BEFORE this process ever verified them are caught on first
    touch — evicted, booked, re-fetched — and the trust latch never
    served them."""
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
        entry = sorted(
            f for f in os.listdir(cache) if f.endswith(".seg")
        )[0]
        path = os.path.join(cache, entry)
        data = bytearray(open(path, "rb").read())
        data[4321] ^= 0x10
        open(path, "wb").write(bytes(data))
        latched0 = metric_total("kta_segstore_cache_verify_latched_total")
        poisoned0 = metric_total(
            "kta_segstore_fallback_total", reason="cache-poisoned"
        )
        before = sum(store.body_gets.values())
        got = run_scan(
            "t", SegmentFileSource(store.url, "t", fetch=fetch),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
        )
        assert scan_doc(got) == ref
        assert sum(store.body_gets.values()) - before == 1
        assert metric_total(
            "kta_segstore_fallback_total", reason="cache-poisoned"
        ) - poisoned0 == 1
        assert metric_total(
            "kta_segstore_cache_verify_latched_total"
        ) == latched0


def test_trust_latch_drops_on_eviction_and_repopulation(tmp_path):
    from kafka_topic_analyzer_tpu_torch.io.objstore import SegmentCache

    cache = SegmentCache(str(tmp_path / "c"), 1 << 20, "store")
    latched0 = metric_total("kta_segstore_cache_verify_latched_total")
    cache.put("a", 3, b"abc")
    assert bytes(cache.get("a", 3)) == b"abc"  # verifying read: latches
    assert bytes(cache.get("a", 3)) == b"abc"  # latched hit
    assert metric_total(
        "kta_segstore_cache_verify_latched_total"
    ) - latched0 == 1
    # Eviction unlatches: the digest's next appearance re-verifies.
    cache.evict("a", 3)
    cache.put("a", 3, b"abc")
    assert bytes(cache.get("a", 3)) == b"abc"
    assert metric_total(
        "kta_segstore_cache_verify_latched_total"
    ) - latched0 == 1
    # Re-population (overwrite) also unlatches.
    cache.put("a", 3, b"abc")
    assert bytes(cache.get("a", 3)) == b"abc"
    assert metric_total(
        "kta_segstore_cache_verify_latched_total"
    ) - latched0 == 1
    # And a further read of the re-verified entry rides the latch again.
    assert bytes(cache.get("a", 3)) == b"abc"
    assert metric_total(
        "kta_segstore_cache_verify_latched_total"
    ) - latched0 == 2


# ---------------------------------------------------------------------------
# the pool's width follows the scan's streams


@pytest.mark.parametrize("workers", [1, 3])
def test_auto_pool_grows_with_resolved_ingest_streams(seg_dir, workers, monkeypatch):
    """Under ``--fetch-concurrency auto`` the engine tells the scheduler
    how many ingest streams the scan resolved (``note_streams``), and the
    pool grows to keep a demand fetch plus read-ahead in flight for each;
    an explicit size is never overridden."""
    monkeypatch.setattr(fetchsched, "default_concurrency", lambda: 1)
    cfg = cpu_cfg()
    with FakeObjectStore(seg_dir) as store:
        got = run_scan(
            "t",
            SegmentFileSource(store.url, "t", fetch=fetch_cfg(2)),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
            ingest_workers=workers,
        )
        grown = fetchsched.get_scheduler().concurrency
        fetchsched._reset_for_tests()
        pinned = run_scan(
            "t",
            SegmentFileSource(store.url, "t", fetch=fetch_cfg(2, fc=1)),
            CpuExactBackend(cfg, init_now_s=10**10), 700,
            ingest_workers=workers,
        )
        assert fetchsched.get_scheduler().concurrency == 1
    assert got.ingest_workers == workers
    assert scan_doc(got) == scan_doc(pinned)
    assert grown == min(fetchsched._MAX_AUTO, workers + 2)
    # The reference's rule gives the same width for the same streams.
    monkeypatch.setattr(ref_fetchsched, "default_concurrency", lambda: 1)
    ref_fetchsched._reset_for_tests()
    try:
        ref_fetchsched.note_streams(workers)
        assert ref_fetchsched.get_scheduler().concurrency == grown
    finally:
        ref_fetchsched._reset_for_tests()
