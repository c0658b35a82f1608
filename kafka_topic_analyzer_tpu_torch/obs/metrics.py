"""Metric name catalog: every instrument the scan pipeline writes (port
of the reference's ``obs/metrics.py``: the whole catalog, with the same
names, types, labels and merge policies, so a port scan exposes the
reference's metric families.  Instruments of features the port does not
have yet (superbatch K > 1, the remote segment tier, follow, fleet,
health) stay declared and read zero).

One module so the full surface is auditable in one place (README
"Observability" documents it verbatim).  All instruments live on the
default registry; they update per batch / per fetch round — never per
record — so instrumentation stays invisible next to decode costs
(tools/bench_ingest.py holds telemetry-on within 2% of off).

Naming follows Prometheus conventions: ``_total`` counters, ``_seconds``
for durations, base units only.
"""

from __future__ import annotations

from kafka_topic_analyzer_tpu_torch.obs.registry import (
    BATCH_SIZE_BUCKETS,
    LATENCY_BUCKETS_S,
    default_registry,
)

_REG = default_registry()

# -- engine (run_scan) --------------------------------------------------------

SCAN_RECORDS = _REG.counter(
    "kta_scan_records_total", "Valid records folded by the scan engine")
SCAN_BATCHES = _REG.counter(
    "kta_scan_batches_total", "Engine steps dispatched (batches)")
SCAN_BYTES = _REG.counter(
    "kta_scan_bytes_total", "Decoded record-batch bytes through the engine")
BATCH_RECORDS = _REG.histogram(
    "kta_batch_records", "Valid records per engine step",
    buckets=BATCH_SIZE_BUCKETS)
STAGE_SECONDS = _REG.counter(
    "kta_stage_seconds_total",
    "Cumulative wall seconds per scan stage, booked LIVE at every stage "
    "window exit (utils/profiling.ScanProfile) so the flight recorder can "
    "sample per-stage occupancy mid-scan",
    labelnames=("stage",))
STAGE_RECORDS = _REG.counter(
    "kta_stage_records_total",
    "Records attributed per scan stage (ScanProfile, booked live)",
    labelnames=("stage",))
STAGE_BYTES = _REG.counter(
    "kta_stage_bytes_total",
    "Decoded bytes attributed per scan stage (ScanProfile, booked live) — "
    "what makes the snapshot-sourced --stats stage digest carry the same "
    "MB/s the old in-process profile summary did",
    labelnames=("stage",))
STAGE_CPU_SECONDS = _REG.counter(
    "kta_stage_cpu_seconds_total",
    "CPU seconds of the drive loop's thread inside each scan stage window "
    "(time.thread_time over the window kta_stage_seconds_total times): "
    "for dispatch, wall - CPU - kta_dispatch_throttle_seconds_total is "
    "the thread's wait for the GIL or the scheduler",
    labelnames=("stage",))
PARTITION_LAG = _REG.gauge(
    "kta_partition_lag",
    "Records between the scan position and the end watermark",
    labelnames=("partition",),
    # Each process feeds (and therefore lags on) a disjoint partition set,
    # so the cross-process merge is a label union; max is the no-op policy
    # for the union case and the honest one if labels ever collide.
    merge="max")
PARTITION_ETA_SECONDS = _REG.gauge(
    "kta_partition_eta_seconds",
    "Projected seconds to drain the partition at the current scan rate",
    labelnames=("partition",),
    # Disjoint per-process label sets (see kta_partition_lag).
    merge="max")
SNAPSHOTS_SAVED = _REG.counter(
    "kta_snapshots_saved_total", "Resumable scan snapshots written")
DEGRADED_PARTITIONS = _REG.gauge(
    "kta_scan_degraded_partitions",
    "Partitions dropped from the scan after exhausting their retry budget",
    # Each process counts ITS locally-degraded partitions (the feeds are
    # disjoint), so the cluster-wide figure is the sum, not the max.
    merge="sum")

# -- parallel ingest (parallel/ingest.py) -------------------------------------

INGEST_QUEUE_DEPTH = _REG.gauge(
    "kta_ingest_queue_depth",
    "Staged batches waiting in a parallel-ingest fan-in's queues "
    "(all of the pool's workers; 0 when the merge loop keeps up). "
    "'pool' is the fan-in's first worker id — sharded-mesh controllers "
    "run one pool per data row, so pools are disjoint and the fleet "
    "depth is the sum",
    labelnames=("pool",),
    # Disjoint pools per controller (and per data row): the cluster-wide
    # queue depth is their sum, not the worst one.
    merge="sum")
INGEST_RESOLVED_WORKERS = _REG.gauge(
    "kta_ingest_resolved_workers",
    "Parallel-ingest worker threads the scan resolved for THIS "
    "controller (after auto/partition-count clamping; 1 = sequential). "
    "Controllers feed disjoint partition sets, so the cross-controller "
    "merge (gather_telemetry) sums to the fleet-wide thread count",
    merge="sum")
INGEST_WORKER_RECORDS = _REG.counter(
    "kta_ingest_worker_records_total",
    "Valid records produced per parallel-ingest worker",
    labelnames=("worker",))
INGEST_WORKER_STALL_SECONDS = _REG.counter(
    "kta_ingest_worker_stall_seconds_total",
    "Seconds each parallel-ingest worker spent blocked on its full "
    "fan-in queue (backpressure from the merge loop/device)",
    labelnames=("worker",))
INGEST_WORKER_ACTIVE_SECONDS = _REG.counter(
    "kta_ingest_worker_active_seconds_total",
    "Thread-lifetime seconds per parallel-ingest worker (stream open to "
    "stream exhausted/cancelled).  The denominator for a worker's busy "
    "fraction: busy = (active - stall) / active — a worker whose "
    "partitions drained early must not read as 'stalled' for the rest "
    "of the scan (obs/doctor.py)",
    labelnames=("worker",))
INGEST_WORKER_CPU_SECONDS = _REG.counter(
    "kta_ingest_worker_cpu_seconds_total",
    "CPU seconds of each parallel-ingest worker's thread "
    "(time.thread_time) over the window "
    "kta_ingest_worker_active_seconds_total brackets: active - CPU is "
    "the worker's waits (sockets, the GIL, its full queue)",
    labelnames=("worker",))

# -- cold segment path (io/segfile.py + io/segstore.py) -----------------------

SEGMENT_FILES_OPENED = _REG.counter(
    "kta_segment_files_opened_total",
    "Segment chunks (.ktaseg) opened by the cold-path catalog")
SEGMENT_BYTES_MAPPED = _REG.counter(
    "kta_segment_bytes_mapped_total",
    "Bytes of segment chunks memory-mapped by the cold-path catalog")
SEGMENT_RECORDS = _REG.counter(
    "kta_segment_records_total",
    "Records read from memory-mapped segment chunks")
SEGMENT_BATCHES = _REG.counter(
    "kta_segment_batches_total",
    "Batches cut from memory-mapped segment chunks")

# -- remote segment tier (io/objstore.py + io/segstore.py) --------------------

SEGSTORE_GETS = _REG.counter(
    "kta_segstore_gets_total",
    "Object-store GET requests the remote segment tier completed, by kind "
    "(list = chunk enumeration, header = catalog header/end-offset range "
    "probes, body = whole-chunk fetches, refetch = the one disambiguating "
    "re-fetch after a classification failure)",
    labelnames=("kind",))
SEGSTORE_BYTES = _REG.counter(
    "kta_segstore_bytes_fetched_total",
    "Bytes fetched from object stores by the remote segment tier "
    "(response bodies of completed GETs)")
SEGSTORE_RETRIES = _REG.counter(
    "kta_segstore_retries_total",
    "Transient object-store request failures retried through the backoff "
    "schedule (resets/timeouts/5xx/truncated or MD5-mismatched bodies)")
SEGSTORE_READAHEAD = _REG.gauge(
    "kta_segstore_readahead_occupancy",
    "Remote chunks currently prefetched (or fetching) ahead of the "
    "consuming ingest streams through the process-wide fetch scheduler "
    "(0..streams x (--segment-readahead + 1))",
    # Each process's streams prefetch disjoint chunks; fleet-wide
    # occupancy is their sum, not the worst stream's.
    merge="sum")
SEGSTORE_CACHE_HITS = _REG.counter(
    "kta_segstore_cache_hits_total",
    "Chunk fetches served from the local segment cache after sha256 "
    "verification (--segment-cache)")
SEGSTORE_CACHE_MISSES = _REG.counter(
    "kta_segstore_cache_misses_total",
    "Chunk fetches the local segment cache could not serve (absent, "
    "unreadable, or poisoned entries)")
SEGSTORE_CACHE_VERIFY_SECONDS = _REG.counter(
    "kta_segstore_cache_verify_seconds_total",
    "Seconds spent sha256-re-hashing cached chunk bytes on cache HITS "
    "(--segment-cache serves nothing unverified).  The warm-re-audit "
    "residual BENCH round 14 measured as 'sha-verify on every hit costs "
    "2.1x' — booked so the claim is attributable from telemetry alone "
    "and the trend doctor can flag verify-bound re-audits")
SEGSTORE_CACHE_HIT_BYTES = _REG.counter(
    "kta_segstore_cache_hit_bytes_total",
    "Chunk bytes served from the local segment cache after sha256 "
    "verification — with the verify-seconds counter, the measured "
    "verify cost per cached byte (the warm-cache residual's ledger)")
SEGSTORE_CACHE_EVICTIONS = _REG.counter(
    "kta_segstore_cache_evictions_total",
    "Cache entries evicted: least-recently-used past --segment-cache-bytes, "
    "plus poisoned entries dropped on detection")
SEGSTORE_FALLBACK = _REG.counter(
    "kta_segstore_fallback_total",
    "Chunk acquisitions that fell back to a direct store fetch, by reason "
    "(cache-poisoned = a cached entry failed sha256 verification, "
    "cache-stale = a verified entry no longer matches the catalog's "
    "header — the archive was re-dumped at the same name and size, "
    "cache-io-error = the cache directory was unreadable/unwritable, "
    "range-ignored = the endpoint answered a ranged GET with the full "
    "object and the requested window was sliced client-side, "
    "etag-not-md5 = a persistent ETag/MD5 mismatch was accepted after a "
    "byte-identical re-fetch — SSE-KMS/SSE-C-shaped ETag) — "
    "a cache bypass is never silent",
    labelnames=("reason",))
SEGSTORE_CACHE_VERIFY_LATCHED = _REG.counter(
    "kta_segstore_cache_verify_latched_total",
    "Cache hits served under the process-lifetime verify latch: the "
    "entry's sha256 was checked once this process and latched as "
    "trusted, so this hit skipped re-hashing (the verify-seconds "
    "counter stands still while this one advances).  Eviction, "
    "re-population, and poison detection all drop the latch, so the "
    "first touch of any on-disk bytes is ALWAYS verified — the PR-14 "
    "never-serve-poison guarantee is unchanged")

# -- process-wide fetch scheduler (io/fetchsched.py) --------------------------

FETCH_SCHED_QUEUE_DEPTH = _REG.gauge(
    "kta_fetch_sched_queue_depth",
    "Fetch requests queued in the process-wide scheduler, not yet "
    "picked up by a worker (demand + speculative).  Persistently "
    "deeper than kta_fetch_sched_inflight = the pool is the "
    "bottleneck — raise --fetch-concurrency",
    # One scheduler per process; fleet-wide backlog is the sum of the
    # per-process queues.
    merge="sum")
FETCH_SCHED_INFLIGHT = _REG.gauge(
    "kta_fetch_sched_inflight",
    "Fetch requests currently executing on scheduler workers "
    "(0..--fetch-concurrency).  Pegged at the pool size with a shallow "
    "queue = the wire, not the scheduler, is the limit",
    # One scheduler per process; fleet-wide in-flight is the sum.
    merge="sum")
FETCH_SCHED_REORDERS = _REG.counter(
    "kta_fetch_sched_reorders_total",
    "Deadline-aware departures from submission order, by reason "
    "(demand-over-speculative = a chunk a consumer is blocked on was "
    "served before earlier-queued speculative read-ahead, "
    "deadline-promotion = a consumer reached a chunk whose speculative "
    "request was still queued and promoted it to demand class)",
    labelnames=("reason",))
FETCH_SCHED_WAIT_SECONDS = _REG.counter(
    "kta_fetch_sched_wait_seconds_total",
    "Cumulative seconds fetch requests spent queued before a scheduler "
    "worker picked them up.  The starvation ledger: high wait with a "
    "deep queue means the pool is undersized, high wait with the pool "
    "pegged and a shallow queue means the wire is saturated "
    "(obs/doctor.py attributes fetch-bound verdicts from exactly this)")
FETCH_SCHED_CANCELLED = _REG.counter(
    "kta_fetch_sched_cancelled_total",
    "Queued fetch requests cancelled before a worker started them: "
    "released chunks (degraded-partition skips), closed streams, and "
    "scheduler shutdown — bytes nobody would have read, not fetched")

# -- fused ingest (packing.FusedPackSink + io/kafka_wire + io/segfile) --------

FUSED_BATCHES = _REG.counter(
    "kta_fused_batches_total",
    "Wire-v4 rows completed by the fused native decode→pack path")
FUSED_RECORDS = _REG.counter(
    "kta_fused_records_total",
    "Records packed by the fused path without a decoded-column "
    "intermediate")
FUSED_FALLBACK = _REG.counter(
    "kta_fused_fallback_total",
    "Records that bypassed the fused decode and entered rows through the "
    "python chain (reason: compressed/legacy frames, per-frame salvage, "
    "python-decoded rows) or skipped fused packing entirely (native shim "
    "disabled/failed, source or backend without fused support)",
    labelnames=("reason",))

# -- packed wire format (packing.py v4/v5; backends book the transfers) -------

WIRE_BYTES = _REG.counter(
    "kta_wire_bytes_total",
    "Packed host→device wire bytes dispatched (buffers as transferred, "
    "superbatch identity padding included)")
WIRE_BYTES_PER_RECORD = _REG.gauge(
    "kta_wire_packed_bytes_per_record",
    "Packed wire bytes per scanned record for the finished scan "
    "(kta_wire_bytes_total delta / records) — the observable v4→v5 "
    "wire saving",
    merge="max")
WIRE_V4_FALLBACK = _REG.counter(
    "kta_wire_v4_fallback_total",
    "Scans that ran the v4 per-record wire format instead of the v5 "
    "combiner rows (reason: env-kill-switch = KTA_WIRE_V4, explicit = "
    "caller pinned v4) — a bypassed combiner is never silent",
    labelnames=("reason",))
ALIVE_PAIRS_RAW = _REG.counter(
    "kta_alive_pairs_raw_total",
    "Per-batch LWW alive-pairs entering the dispatch-level compaction "
    "merge (the compacted path's input side; DESIGN §19)")
ALIVE_PAIRS_EMITTED = _REG.counter(
    "kta_alive_pairs_emitted_total",
    "Merged alive-pairs actually shipped in compacted per-dispatch pair "
    "tables — emitted/raw is the measured compaction ratio the --stats "
    "wire digest reports")
ALIVE_COMPACTION_OFF = _REG.counter(
    "kta_alive_compaction_off_total",
    "Alive-key scans that ran WITHOUT pair compaction (reason: "
    "env-kill-switch = KTA_DISABLE_COMPACTION, explicit = "
    "--alive-compaction off, wire-v4 = the v4 layout keeps per-row "
    "pairs) — a bypassed compaction is never silent",
    labelnames=("reason",))

# -- io/kafka_wire ------------------------------------------------------------

FETCH_REQUESTS = _REG.counter(
    "kta_fetch_requests_total", "Fetch responses read from brokers")
FETCH_BYTES = _REG.counter(
    "kta_fetch_bytes_total", "Record-set bytes carried by fetch responses")
FETCH_SECONDS = _REG.counter(
    "kta_fetch_seconds_total",
    "Seconds spent blocked reading fetch responses off broker sockets "
    "(the wire scan's source-wait side — booked per fetch round, on the "
    "fetching thread, mirroring the 'fetch' trace span)")
DECODE_SECONDS = _REG.counter(
    "kta_decode_seconds_total",
    "Seconds spent in record-set decode: the native whole-response "
    "pre-decode pass and the fused decode→pack appends (booked per fetch "
    "round; the per-frame chain that takes the frames they stop at is "
    "booked on kta_frame_fallback_seconds_total)")
FRAME_FALLBACK_SECONDS = _REG.counter(
    "kta_frame_fallback_seconds_total",
    "Seconds a wire stream spent in the per-frame chain (span "
    "frame-fallback, args frames and records, once a record set with "
    "bytes left over): the frames the fused decode→pack walk and the "
    "whole-response native decode stop at (compressed, legacy, truncated, "
    "poisoned), each parsed, decompressed, decoded and pushed into rows")
DECOMPRESS_SECONDS = _REG.counter(
    "kta_decompress_seconds_total",
    "Seconds spent decompressing record batches, by codec (span "
    "decompress around each frame's decompression, args codec, in and out "
    "bytes)",
    labelnames=("codec",))
DECOMPRESS_IN_BYTES = _REG.counter(
    "kta_decompress_in_bytes_total",
    "Compressed bytes of the record batches decompressed, by codec",
    labelnames=("codec",))
DECOMPRESS_OUT_BYTES = _REG.counter(
    "kta_decompress_out_bytes_total",
    "Bytes the record batches decompressed to, by codec",
    labelnames=("codec",))
INGEST_ROUND_WAIT_SECONDS = _REG.counter(
    "kta_ingest_round_wait_seconds_total",
    "Seconds a wire stream's own thread spent blocked on its fetch "
    "rounds' responses (the fetch pool's map over leaders, or the inline "
    "leader fetch), mirroring the 'round-wait' trace span; "
    "kta_fetch_seconds_total is the pool threads' socket time inside it")
FETCH_ERRORS = _REG.counter(
    "kta_fetch_errors_total",
    "Per-partition Kafka protocol errors in fetch responses")
TRANSPORT_FAILURES = _REG.counter(
    "kta_transport_failures_total",
    "Leader fetch rounds lost to resets/timeouts/truncated streams")
CONNECTION_EVICTIONS = _REG.counter(
    "kta_connection_evictions_total",
    "Broker connections closed as dead or desynced")
METADATA_RELOADS = _REG.counter(
    "kta_metadata_reloads_total",
    "Cluster metadata refreshes attempted during recovery")

# -- corruption (io/kafka_wire + io/kafka_codec) ------------------------------

CORRUPT_FRAMES = _REG.counter(
    "kta_corrupt_frames_total",
    "Frames classified deterministically corrupt and handled by policy",
    labelnames=("kind",))
CORRUPT_RECORDS = _REG.counter(
    "kta_corrupt_records_total",
    "Header-claimed records inside corrupt frames (0 when unreadable)")
CORRUPT_BYTES = _REG.counter(
    "kta_corrupt_bytes_total", "Raw bytes of corrupt frames skipped")
CORRUPT_QUARANTINED = _REG.counter(
    "kta_corrupt_quarantined_total",
    "Corrupt frames spooled to the quarantine directory")
CORRUPT_REFETCHES = _REG.counter(
    "kta_corrupt_refetches_total",
    "Suspect spans re-fetched once to rule out an in-flight bit flip")

# -- log mutation (io/kafka_wire + checkpoint resume) -------------------------

LOG_LOST_RECORDS = _REG.counter(
    "kta_log_lost_records_total",
    "Records the mutating log made unreachable before the scan read them "
    "(reason: retention = expired below the cursor, truncation = removed "
    "by an unclean leader election, resume-below-log-start = expired "
    "while the scan was checkpointed)",
    labelnames=("reason",))
LOG_LOST_RANGES = _REG.counter(
    "kta_log_lost_ranges_total",
    "Contiguous lost offset ranges booked on kta_log_lost_records_total, "
    "plus re-anchor-regressed: OFFSET_OUT_OF_RANGE recoveries whose "
    "earliest-offset lookup failed or regressed (no records booked — the "
    "cursor holds and the round counts as non-progressing)",
    labelnames=("reason",))
LOG_EPOCH_FENCES = _REG.counter(
    "kta_log_epoch_fences_total",
    "FENCED_LEADER_EPOCH / UNKNOWN_LEADER_EPOCH fetch errors (the broker "
    "rejected our tracked leader epoch; metadata is refreshed and the "
    "divergence check runs before the cursor moves)")
LOG_DIVERGENCE_CHECKS = _REG.counter(
    "kta_log_divergence_checks_total",
    "OffsetForLeaderEpoch divergence probes issued on epoch regression "
    "or resume-epoch mismatch (each either clears the cursor or books a "
    "truncation loss)")
LOG_WATERMARK_REGRESSIONS = _REG.counter(
    "kta_log_watermark_regressions_total",
    "Follow-mode end-watermark regressions (stale replica / unclean "
    "election): the service holds the previous head instead of scanning "
    "backwards")

# -- io/retry -----------------------------------------------------------------

BACKOFF_SLEEPS = _REG.counter(
    "kta_backoff_sleeps_total", "Retry/backoff sleeps taken")
BACKOFF_SLEEP_SECONDS = _REG.counter(
    "kta_backoff_sleep_seconds_total", "Seconds spent in retry backoff")
RETRY_BUDGET_EXHAUSTIONS = _REG.counter(
    "kta_retry_budget_exhaustions_total",
    "Partitions whose consecutive-transport-failure budget ran out")

# -- superbatch dispatch (backends/base.py DispatchQueue) ---------------------

DISPATCH_INFLIGHT = _REG.gauge(
    "kta_dispatch_inflight",
    "Superbatch dispatches launched but not yet retired (bounded by "
    "--dispatch-depth; 0 when the device keeps up)",
    # Each process runs its own dispatch queue over its own device rows;
    # the fleet's in-flight figure is their sum, not the worst one.
    merge="sum")
DISPATCH_THROTTLE_SECONDS = _REG.counter(
    "kta_dispatch_throttle_seconds_total",
    "Seconds the drive loop spent blocked in DispatchQueue.throttle "
    "waiting for an in-flight superbatch to retire — the backpressure "
    "wait at the launch site, and the one signal that directly separates "
    "dispatch-bound from ingest-bound scans (booked unconditionally, "
    "flight recorder on or off)")
SUPERBATCH_FILL = _REG.gauge(
    "kta_superbatch_fill",
    "Packed batches accumulated toward the next superbatch dispatch "
    "(0..K; the staging fill level of the current stager ring slot)",
    # Same-quantity gauge across processes (every controller fills its
    # rows in lockstep rounds): report the fleet's fullest pending stack.
    merge="max")
STAGER_SLOTS = _REG.counter(
    "kta_stager_slots_total",
    "Superbatch stager ring slots handed out for assembly "
    "(packing.SuperbatchStager.next_slot) — with kta_dispatch_inflight, "
    "the ring-occupancy signal: slots in use = in-flight dispatches + "
    "the slot being assembled")
SUPERBATCH_SIZE = _REG.histogram(
    "kta_superbatch_size",
    "Packed batches folded per device dispatch (K, or the partial tail)",
    buckets=(1, 2, 4, 8, 16, 32, 64))
DISPATCH_SECONDS = _REG.histogram(
    "kta_dispatch_seconds",
    "Per-dispatch latency: superbatch launch to fold completion "
    "(includes device queue time at depth > 1)",
    buckets=LATENCY_BUCKETS_S)
FOLD_DEVICE_SECONDS = _REG.counter(
    "kta_fold_device_seconds_total",
    "Device seconds from each fold's first launch to its completion "
    "(two timing events on the backend's stream, read when the dispatch "
    "queue retires the fold; waits for the host's next launch within the "
    "fold included); booked on CUDA only")

# -- backends -----------------------------------------------------------------

BACKEND_STEP_SECONDS = _REG.histogram(
    "kta_backend_step_seconds",
    "Backend update dispatch latency (async backends: dispatch only)",
    buckets=LATENCY_BUCKETS_S)
BACKEND_FINALIZE_SECONDS = _REG.histogram(
    "kta_backend_finalize_seconds",
    "Backend finalize (device sync + collective merge) latency",
    buckets=LATENCY_BUCKETS_S)
FINALIZE_PHASE_SECONDS = _REG.counter(
    "kta_finalize_phase_seconds_total",
    "Seconds of each backend finalize phase: drain (retire the in-flight "
    "folds), copy (the state to the host; the mesh's gather and merge) "
    "and derive (popcount and sketch estimates on the host)",
    labelnames=("phase",))
DEVICE_RESIDENT_BYTES = _REG.counter(
    "kta_device_resident_bytes_total",
    "Bytes each backend keeps on its device for its life, added at its "
    "construction and as its alive state grows, by owner: metrics, alive, "
    "hll and quantiles (the state's tensors)",
    labelnames=("owner",))
DEVICE_RESIDENT_MAX = _REG.gauge(
    "kta_device_resident_bytes_max",
    "The most device-resident bytes (kta_device_resident_bytes_total's) "
    "held at once by the process's live backends: the live sum rises at "
    "a backend's construction and falls at its release, and this keeps "
    "its high-water mark (a batch fleet's admitted topics' backends are "
    "live together)")
ALIVE_SET_ENTRIES = _REG.gauge(
    "kta_alive_set_entries",
    "Distinct alive-bitmap slots an exact alive set held at its last "
    "count read back (the single-device backend's set in place of the "
    "dense bitmap; the last backend to read sets it)")
ALIVE_SET_GROWS = _REG.counter(
    "kta_alive_set_grows_total",
    "Rehashes of an exact alive set into a table of twice (or more) its "
    "entries, before an apply could take it past its load limits")
ALIVE_DENSE_CONVERSIONS = _REG.counter(
    "kta_alive_dense_conversions_total",
    "Exact alive sets switched to the dense bitmap, because the next grow "
    "would pass a quarter of the bitmap's bytes")
ALIVE_GROW_SECONDS = _REG.counter(
    "kta_alive_grow_seconds_total",
    "Host seconds of the exact alive set's grows (span alive-grow): the "
    "old table's copy to pinned host memory enqueued (phase stage), then "
    "the larger table's allocation, and the old entries' chunks copied "
    "back and rehashed into it (phase reinsert), all on the backend's "
    "stream; nothing waits for the stream")
ALIVE_GROW_STAGED_BYTES = _REG.counter(
    "kta_alive_grow_staged_bytes_total",
    "Bytes of the old tables' keys and bits that the exact alive set's "
    "grows staged through host memory, so that the old table and the "
    "new one are never on the device at once")
ALIVE_SWITCH_SECONDS = _REG.counter(
    "kta_alive_switch_seconds_total",
    "Seconds of the exact alive set's switches to the dense bitmap (span "
    "alive-switch: the set's copy to the host, which waits for the "
    "stream, its alive slots derived there, and their load into the "
    "bitmap)")
ALIVE_DENSE_PAIRS = _REG.counter(
    "kta_alive_dense_pairs_total",
    "Compacted alive pairs applied to a dense bitmap through its pair "
    "kernel (bitmap_pairs), the pairs a switch loads included")

# -- follow-mode service (serve/follow.py + io/kafka_wire.py) -----------------

FOLLOW_POLLS = _REG.counter(
    "kta_follow_polls_total",
    "Watermark re-polls the follow service took at the head")
FOLLOW_PASSES = _REG.counter(
    "kta_follow_passes_total",
    "Fold passes the follow service ran: the initial catch-up pass, one "
    "per poll that found new records, and the final shutdown commit")
FOLLOW_LAG = _REG.gauge(
    "kta_follow_lag_records",
    "Records between the follow cursor and the latest polled end "
    "watermarks, summed over this process's partitions — recomputed "
    "against the MOVING head every poll, unlike the per-partition "
    "kta_partition_lag gauges a batch scan freezes at its start snapshot",
    # Controllers feed disjoint partition sets; fleet lag is their sum.
    merge="sum")
WATERMARK_REFRESH_FAILURES = _REG.counter(
    "kta_watermark_refresh_failures_total",
    "Watermark re-polls that exhausted the transport retry budget and "
    "kept the previous snapshot (the service retries next poll)")
REPORT_SNAPSHOTS = _REG.counter(
    "kta_report_snapshots_total",
    "Point-in-time report documents published for /report.json (one per "
    "follow poll boundary; the HTTP handler only ever reads the latest)")

# -- the serving plane (obs/exporters.py + serve/push.py, DESIGN §26) ---------

SERVE_REQUESTS = _REG.counter(
    "kta_serve_requests_total",
    "HTTP requests served, by route and status code — 304s, JSON error "
    "bodies, and SSE stream opens each book exactly one row, so the "
    "read path's full traffic mix is reconstructible from the counter",
    labelnames=("route", "status"))
SERVE_NOT_MODIFIED = _REG.counter(
    "kta_serve_not_modified_total",
    "Conditional requests answered 304 Not Modified (If-None-Match "
    "matched the published ETag): zero body bytes on the wire — the "
    "read path's cache-hit count")
SERVE_BYTES = _REG.counter(
    "kta_serve_bytes_total",
    "Response body bytes actually sent, by content encoding (gzip = the "
    "publish-time-compressed variant; identity = raw JSON/text, which "
    "is also where a gzip-requesting client lands when the snapshot "
    "stored no gzip variant — the encoding fallback is visible here, "
    "never silent; sse = streamed event frames)",
    labelnames=("encoding",))
SERVE_SSE_SUBSCRIBERS = _REG.gauge(
    "kta_serve_sse_subscribers",
    "Currently connected /events subscribers (serve/push.py)",
    # Each process serves its own subscriber set; a federated scrape
    # wants the fleet-wide audience.
    merge="sum")
SERVE_SSE_DROPPED = _REG.counter(
    "kta_serve_sse_dropped_total",
    "SSE subscriber streams closed by the publisher, by reason: "
    "slow-client (bounded per-subscriber queue overflowed — eviction "
    "over blocking, the backpressure contract) or shutdown (publisher "
    "stopped with the session) — every eviction books exactly one "
    "reason, never silent",
    labelnames=("reason",))

# -- fleet mode (fleet/discovery.py + fleet/scheduler.py + fleet/service.py) --

FLEET_TOPICS_DISCOVERED = _REG.counter(
    "kta_fleet_topics_discovered_total",
    "Topics returned by all-topics cluster metadata requests (every "
    "discovery pass counts the full listing, pre-filter — re-discovery "
    "polls make this grow by roughly the cluster's topic count per poll)")
FLEET_ADMISSIONS = _REG.counter(
    "kta_fleet_admissions_total",
    "Admission decisions the fleet scheduler took, by reason: "
    "admitted-seed (initial greedy-LPT wave placement), admitted-poll "
    "(a lagging topic granted a pass), deferred-budget (ready but the "
    "concurrency/worker budget was spent), skipped-empty (no lag), "
    "released (scan finished, budget returned) — every decision books "
    "exactly one reason, so the admission trace is reconstructible from "
    "the counter alone (tools/lint.sh rule 10).  'instance' is the "
    "analyzer instance id ('solo' outside a multi-instance fleet) so a "
    "federated scrape attributes decisions to the instance that took them",
    labelnames=("reason", "instance"))
FLEET_TOPICS_ACTIVE = _REG.gauge(
    "kta_fleet_topics_active",
    "Per-topic scans currently admitted and holding budget in this "
    "instance's fleet service",
    labelnames=("instance",),
    # One fleet service per instance; instances own disjoint topic sets
    # (lease-arbitrated), so the cluster-wide figure is the sum.
    merge="sum")
FLEET_TOPIC_LAG = _REG.gauge(
    "kta_fleet_topic_lag_records",
    "Records between a fleet topic's cursor and its latest polled end "
    "watermarks (the per-topic twin of kta_follow_lag_records; admission "
    "weight input)",
    labelnames=("topic", "instance"),
    # Every instance POLLS every topic, but only the lease holder
    # reports its lag (non-holders pin 0 — fleet/service._poll_topic),
    # so the fleet-wide sum counts each topic's lag exactly once.
    merge="sum")
FLEET_REBALANCES = _REG.counter(
    "kta_fleet_rebalances_total",
    "Budget rebalances the fleet scheduler applied between polls "
    "(doctor-verdict driven: ingest-bound scans shed dispatch share and "
    "gain workers freed from dispatch-bound scans)",
    labelnames=("instance",))
FLEET_FAILOVERS = _REG.counter(
    "kta_fleet_failovers_total",
    "Topic ownership takeovers: this instance acquired a topic lease "
    "whose previous holder was a DIFFERENT instance (expired or "
    "released) — the crash-failover trace (fleet/lease.py; DESIGN §23)",
    labelnames=("instance",))

FLEET_ADMISSION_WAIT_SECONDS = _REG.counter(
    "kta_fleet_admission_wait_seconds_total",
    "Seconds the fleet's topics waited for a grant, each from its offer "
    "to admission (a batch fleet's start; the first follow poll that "
    "found it lagging) to the start of its pass (span fleet-admit)")
FLEET_PASS_SECONDS = _REG.counter(
    "kta_fleet_pass_seconds_total",
    "Wall seconds of the fleet's topic passes, each from its backend's "
    "construction or re-grant to its report (span fleet-pass)")
FLEET_BACKENDS_RELEASED = _REG.counter(
    "kta_fleet_backends_released_total",
    "Topic backends a batch fleet closed when their pass ended, freeing "
    "their device state before the next admission: the topics that "
    "passed, less any whose close raised (a fleet follow keeps its "
    "backends, and books none)")

# -- topic ownership leases (fleet/lease.py) ----------------------------------

LEASE_ACQUISITIONS = _REG.counter(
    "kta_lease_acquisitions_total",
    "Lease acquisition attempts by outcome: acquired (fresh or "
    "re-entrant grant), takeover (expired/released lease of ANOTHER "
    "instance claimed — also books kta_fleet_failovers_total), "
    "held-elsewhere (an unexpired lease blocks this instance), "
    "lost-race (a competing writer landed between read and "
    "conditional write), released (a held lease handed back; epoch "
    "retained in the store), store-error (the lease store was "
    "unreachable after retries) — every acquire/release decision "
    "books exactly one outcome (tools/lint.sh rule 13); never silent",
    labelnames=("outcome", "instance"))
LEASE_RENEWALS = _REG.counter(
    "kta_lease_renewals_total",
    "Lease renewal attempts by outcome: renewed (expiry extended "
    "through the store), deferred (transient store outage — the lease "
    "is still locally unexpired, so the holder keeps scanning and "
    "retries next boundary rather than self-fencing early)",
    labelnames=("outcome", "instance"))
LEASE_LOSSES = _REG.counter(
    "kta_lease_losses_total",
    "Leases this instance held and LOST without releasing: fenced (the "
    "store shows a newer epoch/different owner, or a stale-epoch "
    "checkpoint write was refused — checkpoint.py books the refusal "
    "here too) or expired (the local TTL ran out before any renewal "
    "succeeded).  The zombie-fencing trace; fires the lease_lost alert",
    labelnames=("instance",))
LEASE_HELD = _REG.gauge(
    "kta_lease_held",
    "1 while this instance holds the topic's ownership lease, 0 once "
    "released or lost (fleet/lease.py)",
    labelnames=("topic", "instance"),
    # (topic, instance) label sets are disjoint across processes by
    # construction — at most one holder per topic; sum unions them and
    # totals the cluster's currently-owned topics.
    merge="sum")

# -- flight recorder (obs/flight.py) ------------------------------------------

FLIGHT_SAMPLES = _REG.counter(
    "kta_flight_samples_total",
    "Occupancy samples the flight recorder took (--flight-record) — the "
    "recorder's own cost stays auditable in the data it records")

# -- telemetry history (obs/history.py) ---------------------------------------

HISTORY_SAMPLES = _REG.counter(
    "kta_history_samples_total",
    "Sample rows appended to the disk-backed telemetry history "
    "(--history-bytes; tier-0 appends — downsampled tier rows are "
    "derived, not re-counted)")
HISTORY_ROTATIONS = _REG.counter(
    "kta_history_segment_rotations_total",
    "History segment files sealed by atomic rotation (all tiers) — with "
    "kta_history_bytes, the store's write/retention cadence")
HISTORY_BYTES = _REG.gauge(
    "kta_history_bytes",
    "Bytes the telemetry history currently holds on disk (all tiers, "
    "open segments included; bounded by --history-bytes)",
    # One store per process; a fleet of processes holds disjoint stores.
    merge="sum")

# -- health / alerting (obs/health.py) ----------------------------------------

HEALTH_EVALUATIONS = _REG.counter(
    "kta_health_evaluations_total",
    "Alert-engine evaluation passes (poll boundaries + the rate-limited "
    "heartbeat hook) — /healthz serves 503 until this first moves")
ALERTS_FIRING = _REG.gauge(
    "kta_alerts_firing",
    "Alerts currently ACTIVE (firing or in resolve hysteresis) per "
    "rule; under fleet per-topic rules this counts the topics the rule "
    "is firing for",
    labelnames=("rule",),
    # Each process's engine fires over its own scan; fleet-wide active
    # alerts are the sum, not the worst process's.
    merge="sum")
ALERTS_TRANSITIONS = _REG.counter(
    "kta_alerts_transitions_total",
    "Alert state-machine transitions by rule and entered state "
    "(ok/pending/firing/resolving) — every state change books exactly "
    "one row, so the alert trace is reconstructible from the counter "
    "alone (tools/lint.sh rule 12); no silent state changes",
    labelnames=("rule", "state"))
