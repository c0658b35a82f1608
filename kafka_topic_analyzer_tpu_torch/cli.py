"""Command line of the port: the Kafka wire, synthetic and segment-file
batch scans (port of the reference's ``cli.py``, the flags of the ported
single-scan paths).

    python -m kafka_topic_analyzer_tpu_torch -t T \\
        ([--source kafka] -b HOST:PORT [--librdkafka K=V,...] \\
         | --source synthetic --synthetic SPEC \\
         | --source segfile --segment-dir DIR|URL \\
           [--segment-readahead N|auto] [--fetch-concurrency N|auto] \\
           [--segment-cache DIR [--segment-cache-bytes B]]) \\
        [-c] [--distinct-keys] [--distinct-keys-per-partition] \\
        [--quantiles] [--quantiles-per-partition] [--extremes-table] \\
        [--pallas] [--batch-size B] [--alive-bitmap-bits N] \\
        [--wire-format auto|v4|v5] [--alive-compaction auto|off] \\
        [--native auto|on|off] [--backend gpu|tpu|cpu] [--device cuda|cpu] \\
        [--superbatch K|auto] [--dispatch-depth D] [--ingest-workers N|auto] \\
        [--snapshot-dir DIR [--snapshot-every S] [--resume]] [--check-crcs] \\
        [--on-corruption fail|skip|quarantine] [--quarantine-dir DIR] \\
        [--on-data-loss fail|report|ignore] \\
        [--from-timestamp ISO8601|EPOCH_MS] [--dump-segments DIR] \\
        [--quiet] [--json] [--stats] [--profile-dir DIR] [--metrics-port PORT] \\
        [--sse] [--no-serve-gzip] [--history-bytes B] \\
        [--events-jsonl FILE] [--trace-json FILE] [--flight-record] \\
        [--follow [--poll-interval S] [--checkpoint-interval S] \\
         [--follow-idle-exit S] [--window-secs S] [--window-count N]] \\
        [--fleet [--fleet-exclude GLOBS] [--fleet-internal] \\
         [--fleet-concurrency N|auto] [--instance-id [ID] \\
          [--lease-ttl S] [--lease-store auto|file|object]]] \\
        [--mesh DATA[,SPACE]] [--distributed COORD:PORT,PID,NPROCS]

Prints the same report bytes as the reference CLI for the same inputs
(apart from the two timing lines), with the reference's DEGRADED, CORRUPT
and DATA-LOSS blocks after it; ``--json`` prints the reference's JSON
document instead (banners on stderr).  ``--source kafka`` (the default)
reads the topic over the Kafka wire protocol; ``--source segfile`` reads
``.ktaseg`` dumps from a local directory or, through the remote segment
tier, from an S3-shaped object store (``http(s)://host[:port]/bucket
[/prefix]`` or ``s3://bucket[/prefix]``).

``--backend`` takes the reference's names: ``cpu`` is the numpy exact
oracle (`backends.cpu.CpuExactBackend`, which touches no device), and
``tpu`` is accepted as a spelling of ``gpu``, the torch backend.  The one
intended divergence is the default, ``gpu`` where the reference's is
``cpu``.  ``--device`` places the torch backend: ``cuda`` (the default)
runs on the first CUDA device and fails when there is none; ``cpu`` runs
the same code on the host (the port's counterpart of the reference's
``JAX_PLATFORMS=cpu``).

``--stats`` writes the stage digest, the telemetry counters and the scan
doctor's BOTTLENECK verdict to stderr; ``--profile-dir`` writes a
``torch.profiler`` Chrome trace of the scan (CUDA activity included on
the card); ``--metrics-port``, ``--events-jsonl``, ``--trace-json`` and
``--flight-record`` attach the reference's telemetry sinks (`obs`).
``KTA_LOG``/``RUST_LOG`` set the log levels.  ``--native`` chooses the native ingest
shim: ``auto`` (the default) uses it when it builds and falls back to
numpy otherwise, ``on`` raises when it cannot be built, ``off`` runs
numpy only (and so the chained, not the fused, Kafka and segment-file
paths).  ``--ingest-workers`` shards the partitions over N ingest
threads merged in a fixed round-robin order; ``--snapshot-dir`` saves
resumable snapshots (every ``--snapshot-every`` seconds, on a failure or
an interrupt, and when the scan degraded or skipped records) that
``--resume`` continues from, in this CLI or the reference's.
``--superbatch K`` folds K rows per device dispatch (the torch backend
only).  ``--mesh D[,S]`` runs the torch backend over a (data, space)
mesh of shards (`parallel.sharded.ShardedTorchBackend`): partitions split
over D data rows, each row's batch into S chunks, the shards placed
round-robin on the visible CUDA devices (``--device cpu``: the host).
It composes with every source, ``--ingest-workers`` (split over the
rows), ``--superbatch``, ``--resume``, ``--follow`` and ``-t a,b,c``;
``--fleet`` refuses it, as the reference does.  ``--distributed
COORD:PORT,PID,NPROCS`` runs one controller per process: every process
runs the same command with its own PID, joins one gloo process group at
COORD:PORT, feeds its own block of the mesh's data rows (each resolves
``--ingest-workers`` against its rows' partitions) and snapshots them to
a file of its own; the processes agree once per round and merge at
finalize, process 0 alone prints the report (or ``--json``), and every
process exits with the scan's status.  The banners of the other
processes go to stderr.  ``--follow`` and ``--fleet`` refuse it, as the
reference does.

``--follow`` runs the scan as a service (`serve.follow.FollowService`):
after the initial pass it re-polls the watermarks every
``--poll-interval`` seconds and folds what arrived by re-entering the
scan on the same backend, whose state stays on the device; it publishes
the report document at ``/report.json`` on ``--metrics-port`` (with
``/healthz``, and ``/events`` under ``--sse``), checkpoints every
``--checkpoint-interval`` seconds with ``--snapshot-dir``, and stops at
the next poll boundary on SIGINT/SIGTERM or after
``--follow-idle-exit`` seconds at the head, then prints the report as a
batch scan would.  ``-t a,b,c`` scans several topics through one
backend (`io.multi.MultiTopicSource`): one report per topic and a
cross-topic union block.  ``--history-bytes`` keeps the flight
recorder's series on disk next to the snapshots and serves it at
``/history``.  ``--fleet`` discovers the cluster's topics (``-t``
becomes include globs) and scans each on a backend of its own, up to
``--fleet-concurrency`` at once on CUDA streams of their own, sharing
the ``--ingest-workers`` and ``--dispatch-depth`` budgets
(`fleet.service.FleetService`); ``-t a,b --follow`` runs the named
topics through the same service; ``--instance-id`` splits the topics
between analyzer instances by lease.  Exit
status: 254 for an empty topic (the reference's ``exit(-2)``), 1 for an
error, 3 when partitions degraded, 4 when corrupt frames were skipped, 5
when ``--on-data-loss fail`` aborted the scan (after its checkpoint, with
``--snapshot-dir``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, Optional

from kafka_topic_analyzer_tpu_torch import __version__
from kafka_topic_analyzer_tpu_torch.backends.base import MetricBackend, make_backend
from kafka_topic_analyzer_tpu_torch.config import (
    AnalyzerConfig,
    CorruptionConfig,
    DataLossConfig,
    DispatchConfig,
    IngestConfig,
    SegmentFetchConfig,
    TransportRetryConfig,
)
from kafka_topic_analyzer_tpu_torch.engine import ScanResult, run_scan
from kafka_topic_analyzer_tpu_torch.io import native
from kafka_topic_analyzer_tpu_torch.io.kafka_codec import KafkaProtocolError
from kafka_topic_analyzer_tpu_torch.io.kafka_wire import DataLossError, KafkaWireSource
from kafka_topic_analyzer_tpu_torch.io.segfile import (
    SegmentDumpWriter,
    SegmentFileSource,
    TeeSource,
)
from kafka_topic_analyzer_tpu_torch.io.source import RecordSource
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.obs import health as obs_health
from kafka_topic_analyzer_tpu_torch.obs import history as obs_history
from kafka_topic_analyzer_tpu_torch.obs import telemetry_session
from kafka_topic_analyzer_tpu_torch.parallel.mesh import (
    initialize_distributed,
    process_index,
    shutdown_distributed,
)
from kafka_topic_analyzer_tpu_torch.report import (
    attach_issue_blocks,
    attach_scan_digests,
    build_json_doc,
    render_bottleneck,
    render_corrupt_block,
    render_data_loss_block,
    render_degraded_block,
    render_extremes_table,
    render_health,
    render_report,
    render_stage_stats,
    render_telemetry_stats,
    render_trends,
)
from kafka_topic_analyzer_tpu_torch.utils.log import init_logging
from kafka_topic_analyzer_tpu_torch.utils.profiling import maybe_torch_trace
from kafka_topic_analyzer_tpu_torch.utils.progress import Spinner

#: Exit status of a scan of an empty topic (the reference's ``exit(-2)``).
EXIT_EMPTY_TOPIC = 254
#: The scan finished but dropped partitions whose retry budget ran out:
#: the report undercounts them.  Takes precedence over `EXIT_CORRUPT`.
EXIT_DEGRADED = 3
#: The scan finished but skipped deterministically corrupt frames
#: (``--on-corruption skip|quarantine``): the metrics exclude their records.
EXIT_CORRUPT = 4
#: ``--on-data-loss fail`` aborted the scan because the log moved under it.
EXIT_DATA_LOSS = 5


def parse_kv_pairs(text: Optional[str]) -> Dict[str, str]:
    """Parse ``"a=b,c=d"`` like the reference's ``--librdkafka`` surface."""
    if not text:
        return {}
    out: Dict[str, str] = {}
    for pair in text.split(","):
        k, _, v = pair.partition("=")
        out[k] = v
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kafka-topic-analyzer",
        description="An analyzer for getting metrics about the contents of an "
        "Apache Kafka topic (PyTorch/CUDA port)",
    )
    p.add_argument("-V", "--version", action="version",
                   version=f"kafka-topic-analyzer-tpu-torch {__version__}")
    p.add_argument("-t", "--topic", required=True, metavar="TOPIC",
                   help="The topic to analyze")
    p.add_argument("-b", "--bootstrap-server", metavar="BOOTSTRAP_SERVER",
                   help="Bootstrap server(s) to work with, comma separated")
    p.add_argument("--librdkafka", metavar="LIBRDKAFKA",
                   help="Options to pass into the underlying consumer, comma "
                        "separated key=value pairs")
    p.add_argument("-c", "--count-alive-keys", action="store_true",
                   help="Counts the effective number of alive keys in a log "
                        "compacted topic. A key is 'alive' when it is present "
                        "and has a non-null value in its latest-offset version")
    p.add_argument("--backend", choices=["cpu", "tpu", "gpu"], default="gpu",
                   help="Metric backend: numpy exact oracle (cpu) or the "
                        "torch streaming reducers (gpu; tpu is accepted as "
                        "the reference's name for it). Default: gpu")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Where the torch backend runs: the first CUDA "
                        "device (cuda; fails when there is none) or the "
                        "host (cpu). The oracle ignores it. Default: cuda")
    p.add_argument("--source", choices=["kafka", "synthetic", "segfile"],
                   default="kafka",
                   help="Record source. 'kafka' reads the real topic via the "
                        "wire protocol; 'synthetic'/'segfile' are cluster-free")
    p.add_argument("--synthetic", metavar="SPEC",
                   help="Synthetic workload spec, comma separated k=v: "
                        "partitions,messages,keys,key_null,tombstones,vmin,"
                        "vmax,seed")
    p.add_argument("--segment-dir", metavar="DIR|URL",
                   help="Segment store of .ktaseg dumps (--source segfile): "
                        "a local directory (or file://DIR), or a remote "
                        "object store — http(s)://host[:port]/bucket"
                        "[/prefix] for any S3-compatible endpoint "
                        "(path-style), s3://bucket[/prefix] through "
                        "KTA_S3_ENDPOINT. Composes with --ingest-workers, "
                        "--superbatch, --segment-readahead and "
                        "--segment-cache")
    p.add_argument("--segment-readahead", default="auto", metavar="N|auto",
                   help="Remote chunks kept in flight ahead of each ingest "
                        "stream (the per-stream window over the shared "
                        "fetch scheduler). 'auto' = 4 for remote stores, "
                        "0 (demand-only) for local directories. Results "
                        "are byte-identical at any depth. Default: auto")
    p.add_argument("--fetch-concurrency", default="auto", metavar="N|auto",
                   help="Worker count of the ONE process-wide fetch "
                        "scheduler every remote segment byte is admitted "
                        "through. Demand requests outrank speculative "
                        "read-ahead; streams share the pool fairly. 'auto' "
                        "sizes from the host and grows with the resolved "
                        "stream count. Default: auto")
    p.add_argument("--segment-cache", metavar="DIR",
                   help="Local chunk cache for remote segment stores: "
                        "fetched chunks land here (atomic rename-in, "
                        "sha256 sidecar), are sha256-verified at first "
                        "touch each process (then latched as trusted and "
                        "served as zero-copy mmap views); a flipped byte "
                        "is detected, booked and re-fetched, never served")
    p.add_argument("--segment-cache-bytes", type=int, default=1 << 30,
                   metavar="BYTES",
                   help="Size bound of --segment-cache: inserts evict "
                        "least-recently-used entries past it. "
                        "Default: 1 GiB")
    p.add_argument("--batch-size", type=int, default=1 << 18,
                   help="Records per device step")
    p.add_argument("--alive-bitmap-bits", type=int, default=32,
                   help="log2 of alive-key bitmap slots (32 = reference-exact)")
    p.add_argument("--distinct-keys", action="store_true",
                   help="Also estimate distinct keys with a HyperLogLog sketch")
    p.add_argument("--distinct-keys-per-partition", action="store_true",
                   help="Track one HLL register file per partition "
                        "(implies --distinct-keys)")
    p.add_argument("--quantiles", action="store_true",
                   help="Also compute message-size quantiles (DDSketch)")
    p.add_argument("--quantiles-per-partition", action="store_true",
                   help="Track one size-quantile sketch per partition "
                        "(implies --quantiles)")
    p.add_argument("--superbatch", default="1", metavar="K|auto",
                   help="Superbatch dispatch: fold K packed rows per "
                        "device dispatch (one throttle, one completion "
                        "event and, under alive compaction, one merged "
                        "pair table per K rows) with byte-identical "
                        "results. 'auto' targets 2^20 records per "
                        "dispatch (min 1, max 16), capped at 2^18 records "
                        "per dispatch; an explicit K is never capped. "
                        "Default: 1. Requires --backend gpu or tpu")
    p.add_argument("--dispatch-depth", type=int, default=2, metavar="D",
                   help="Superbatches allowed in flight while the device "
                        "folds; the drive loop blocks (backpressuring "
                        "ingest) beyond it. Default: 2")
    p.add_argument("--ingest-workers", default="1", metavar="N|auto",
                   help="Parallel partition-sharded ingest for one scan: "
                        "shard the partition set over N private "
                        "fetch+decode+pack worker threads feeding the "
                        "backend through a deterministic fan-in. 'auto' "
                        "sizes from the host (min(cores-1, partitions)). "
                        "Default: 1")
    p.add_argument("--pallas", action="store_true",
                   help="The reference's Pallas counter flag: under wire v4 "
                        "it requires batch-size %% 1024 == 0 and rejects "
                        "values over 16 MiB - 1, as the reference does. The "
                        "port's counter folds run their CUDA kernels on a "
                        "GPU with or without it")
    p.add_argument("--wire-format", choices=["auto", "v4", "v5"],
                   default="auto", metavar="auto|v4|v5",
                   help="Packed host→device wire format: v5 (combiner rows "
                        "— host pre-reduced per-partition fold tables, the "
                        "default) or v4 (per-record columns). 'auto' "
                        "resolves to v5. Results are byte-identical either "
                        "way")
    p.add_argument("--alive-compaction", choices=["auto", "off"],
                   default="auto", metavar="auto|off",
                   help="Host-side LWW compaction of the alive-key pairs "
                        "into one bounded per-dispatch table (wire v5 "
                        "only). 'auto' (default) compacts whenever -c runs "
                        "under v5; 'off' keeps the per-row pair sections. "
                        "Results are byte-identical either way")
    p.add_argument("--native", choices=["auto", "on", "off"], default="auto",
                   help="Use the native C++ ingest shim when available "
                        "(auto), always (on: fail if it cannot be built) "
                        "or never (off)")
    p.add_argument("--snapshot-dir", metavar="DIR",
                   help="Periodically save resumable scan snapshots here")
    p.add_argument("--snapshot-every", type=float, default=60.0,
                   metavar="SECONDS", help="Snapshot interval (default 60s)")
    p.add_argument("--resume", action="store_true",
                   help="Resume from a snapshot in --snapshot-dir if present")
    p.add_argument("--from-timestamp", metavar="ISO8601|EPOCH_MS",
                   help="Scan only records at or after this time (kafka "
                        "source: broker-side ListOffsets timestamp lookup). "
                        "Accepts epoch milliseconds or ISO-8601, e.g. "
                        "2026-01-01T00:00:00")
    p.add_argument("--dump-segments", metavar="DIR",
                   help="While scanning, dump record metadata into .ktaseg "
                        "chunks so the topic can be re-analyzed from disk")
    p.add_argument("--check-crcs", action="store_true",
                   help="Verify record-batch checksums (CRC32-C) while "
                        "decoding, like librdkafka's check.crcs. Without it, "
                        "corruption detection only catches structural "
                        "damage; payload bit rot decodes as garbage values")
    p.add_argument("--on-corruption", choices=["fail", "skip", "quarantine"],
                   default="fail", metavar="POLICY",
                   help="What to do with a deterministically corrupt record "
                        "frame (one that fails decode identically on a "
                        "re-fetch): 'fail' aborts the scan (default), 'skip' "
                        "skips exactly that frame and finishes with exit "
                        f"code {EXIT_CORRUPT}, 'quarantine' additionally "
                        "spools the raw frame + JSON sidecar to "
                        "--quarantine-dir")
    p.add_argument("--quarantine-dir", metavar="DIR",
                   help="Directory for quarantined corrupt frames "
                        "(requires --on-corruption=quarantine)")
    p.add_argument("--on-data-loss", choices=["fail", "report", "ignore"],
                   default="report", metavar="POLICY",
                   help="What to do when the log mutates out from under "
                        "the scan (retention races past the cursor, "
                        "truncation after an unclean leader election): "
                        f"'fail' aborts with exit code {EXIT_DATA_LOSS}, "
                        "'report' (default) finishes with exit 0 and a "
                        "DATA-LOSS block naming every lost range, 'ignore' "
                        "finishes with exit 0 and no block")
    p.add_argument("--json", action="store_true",
                   help="Emit the report as JSON on stdout instead of the "
                        "terminal tables")
    p.add_argument("--extremes-table", action="store_true",
                   help="Also print a per-partition first/last-timestamp and "
                        "min/max-size table")
    p.add_argument("--profile-dir", metavar="DIR",
                   help="Write a torch.profiler Chrome trace of the scan "
                        "(CPU activity, and CUDA activity on the card) to "
                        "DIR/torch_trace.json")
    p.add_argument("--stats", action="store_true",
                   help="Print per-stage throughput stats, the telemetry "
                        "counter digest and the BOTTLENECK verdict to stderr")
    p.add_argument("--metrics-port", type=int, metavar="PORT",
                   help="Serve Prometheus metrics on "
                        "http://127.0.0.1:PORT/metrics while the scan runs "
                        "(0 binds an ephemeral port)")
    p.add_argument("--sse", action="store_true",
                   help="Push a Server-Sent-Events stream of report "
                        "publishes at /events on --metrics-port: each "
                        "frame carries the new snapshot's seq and a "
                        "compact delta summary, so dashboards re-fetch "
                        "/report.json only when it actually changed "
                        "(requires --metrics-port)")
    p.add_argument("--no-serve-gzip", action="store_true",
                   help="Disable publish-time gzip of /report.json "
                        "bodies (the default compresses once per "
                        "publish and serves the cached encoding to "
                        "Accept-Encoding: gzip readers)")
    p.add_argument("--history-bytes", type=int, default=0, metavar="BYTES",
                   help="Persist the flight recorder's telemetry series "
                        "to a crash-safe, multi-resolution on-disk store "
                        "bounded by BYTES (recent history at full "
                        "resolution, older history progressively halved), "
                        "living next to the checkpoints (requires "
                        "--snapshot-dir) so a restarted service resumes "
                        "its series. Serves windowed queries at /history "
                        "on --metrics-port and feeds the TRENDS digest of "
                        "--stats")
    p.add_argument("--mesh", metavar="DATA[,SPACE]", default="1",
                   help="Device mesh shape: data shards[, space shards]. "
                        "Data shards split the partitions, space shards "
                        "each data row's batch and the alive bitmap's slot "
                        "space; the shards go round-robin onto the visible "
                        "CUDA devices (or the host under --device cpu), so "
                        "one card can hold them all")
    p.add_argument("--distributed", metavar="COORD:PORT,PID,NPROCS",
                   help="Multi-controller mode: join the gloo process group "
                        "at the given coordinator address as process PID "
                        "of NPROCS before building the mesh; each process "
                        "feeds its own block of the --mesh data rows, and "
                        "process 0 prints the report"),
    p.add_argument("--fleet", action="store_true",
                   help="Cluster-wide topic discovery and scan: ask the "
                        "cluster for all topics (one all-topics Metadata "
                        "request), filter them (-t becomes a comma-"
                        "separated include-glob list, default '*'; "
                        "--fleet-exclude subtracts; internal "
                        "__consumer_offsets-style topics are excluded "
                        "unless --fleet-internal), then scan every match, "
                        "up to --fleet-concurrency topics at once, sharing "
                        "the global --ingest-workers and --dispatch-depth "
                        "budgets (each topic's backend on a CUDA stream of "
                        "its own).  Per-topic results equal solo scans; one "
                        "topic's failure becomes a status row.  Composes "
                        "with --follow, --json (cluster rollup and "
                        "per-topic documents), --snapshot-dir (one "
                        "subdirectory per topic) and /report.json?topic= on "
                        "--metrics-port")
    p.add_argument("--fleet-exclude", metavar="GLOBS",
                   help="Comma-separated topic-name globs to exclude "
                        "from --fleet discovery (applied after the -t "
                        "include globs)")
    p.add_argument("--fleet-internal", action="store_true",
                   help="Include broker-internal topics "
                        "(__consumer_offsets-style; metadata-flagged or "
                        "__-prefixed) in --fleet discovery")
    p.add_argument("--fleet-concurrency", default="auto", metavar="N|auto",
                   help="Per-topic scans admitted concurrently under "
                        "--fleet ('auto' sizes from the worker budget "
                        "and topic count); the rest wait until budget "
                        "returns. Default: auto")
    p.add_argument("--instance-id", metavar="ID", default=None,
                   nargs="?", const="auto",
                   help="This analyzer's identity in a multi-instance "
                        "fleet: turns on per-topic ownership leases, so N "
                        "analyzers pointed at one cluster split the topics "
                        "instead of scanning each twice, with crash "
                        "failover by lease expiry. Requires --fleet (or "
                        "--follow with a topic list) and a lease store "
                        "(--snapshot-dir for file leases, or a remote "
                        "--segment-dir spec with --lease-store object). "
                        "Bare --instance-id derives HOSTNAME-PID")
    p.add_argument("--lease-ttl", type=float, default=30.0,
                   metavar="SECONDS",
                   help="Topic-lease lifetime under --instance-id: a "
                        "crashed instance's topics are taken over this "
                        "long after its last renewal. Renewals ride every "
                        "poll boundary. Default: 30")
    p.add_argument("--lease-store", default="auto",
                   metavar="auto|file|object",
                   help="Where lease records live: 'file' = JSON records "
                        "under SNAPSHOT_DIR/_kta_leases/, 'object' = "
                        "ETag-fenced conditional writes to the remote "
                        "--segment-dir store, 'auto' (default) picks "
                        "'object' when --segment-dir is remote, else "
                        "'file'")
    p.add_argument("--follow", action="store_true",
                   help="Run as a long-lived analyzer service: after the "
                        "initial earliest→latest pass, keep re-polling "
                        "watermarks and fold new records incrementally on "
                        "the same device state, serving the evolving "
                        "report at /report.json on --metrics-port. "
                        "SIGINT/SIGTERM stop at the next poll boundary: "
                        "final checkpoint, final report, clean exit. "
                        "Resumes from any --snapshot-dir snapshot, "
                        "including one a batch scan wrote")
    p.add_argument("--poll-interval", type=float, default=1.0,
                   metavar="SECONDS",
                   help="Follow-mode watermark poll cadence; consecutive "
                        "empty polls back off exponentially from here to "
                        "10s. Default: 1.0")
    p.add_argument("--checkpoint-interval", type=float, default=None,
                   metavar="SECONDS",
                   help="Follow-mode checkpoint cadence (committed only "
                        "at superbatch boundaries; requires "
                        "--snapshot-dir). Defaults to --snapshot-every")
    p.add_argument("--follow-idle-exit", type=float, default=None,
                   metavar="SECONDS",
                   help="Exit the follow service cleanly after this long "
                        "at the head with no new records (drain mode); "
                        "default: follow forever")
    p.add_argument("--window-secs", type=float, default=60.0,
                   metavar="SECONDS",
                   help="Width of one follow-mode report window (the "
                        "time-windowed per-partition rate/cardinality/"
                        "size folds served in /report.json). Default: 60")
    p.add_argument("--window-count", type=int, default=8, metavar="N",
                   help="Window states kept in the follow-mode ring "
                        "(merged associatively for the whole-ring view); "
                        "0 disables windowed folds. Default: 8")
    p.add_argument("--events-jsonl", metavar="FILE",
                   help="Append structured scan lifecycle + transport-fault "
                        "events to FILE as JSON lines")
    p.add_argument("--trace-json", metavar="FILE",
                   help="Write a Chrome trace-event JSON of host-side scan "
                        "spans (fetch rounds, decode/pack, staging, stages, "
                        "finalize phases) to FILE; with --profile-dir the "
                        "host spans are also merged into DIR/torch_trace.json "
                        "on the profiler's time base, one track a thread")
    p.add_argument("--flight-record", action="store_true",
                   help="Run the pipeline flight recorder: per-stage "
                        "occupancy time series while the scan runs, adding "
                        "windowed verdicts to the --stats BOTTLENECK "
                        "digest, counter tracks to --trace-json and "
                        "/flight on --metrics-port")
    p.add_argument("--quiet", action="store_true", help="No progress spinner")
    return p


def resolve_wire_format(args) -> int:
    """--wire-format → AnalyzerConfig.wire_format: 'auto' = 0 (the config
    resolves it to v5), 'v4'/'v5' pin the format."""
    return {"auto": 0, "v4": 4, "v5": 5}[args.wire_format]


def resolve_native(args) -> bool:
    """--native → whether to use the shim: ``on`` loads it or raises,
    ``auto`` uses it when it loads."""
    if args.native == "on":
        native.load_library()
        return True
    return args.native == "auto" and native.native_available()


def parse_timestamp_ms(text: str) -> int:
    """Epoch milliseconds, or ISO-8601 (naive strings are taken as UTC).
    Negative values are refused: they collide with Kafka's ListOffsets
    sentinels (-1 latest, -2 earliest)."""
    try:
        ms = int(text)
    except ValueError:
        import datetime

        try:
            dt = datetime.datetime.fromisoformat(text)
        except ValueError as e:
            raise ValueError(
                f"bad --from-timestamp {text!r}: expected epoch ms or ISO-8601"
            ) from e
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=datetime.timezone.utc)
        ms = int(dt.timestamp() * 1000)
    if ms < 0:
        raise ValueError(
            f"bad --from-timestamp {text!r}: must not be before the epoch"
        )
    return ms


def parse_from_timestamp_flag(args) -> "int | None":
    """--from-timestamp in ms, refused for sources without a broker-side
    timestamp index."""
    if not args.from_timestamp:
        return None
    if args.source != "kafka":
        raise ValueError(
            "--from-timestamp requires --source kafka (broker-side "
            "timestamp index lookup)"
        )
    if args.resume:
        raise ValueError(
            "--from-timestamp cannot be combined with --resume (the "
            "snapshot's offsets already fix where the scan continues); "
            "drop --resume to seek to the timestamp, or drop "
            "--from-timestamp to resume the snapshot"
        )
    return parse_timestamp_ms(args.from_timestamp)


def make_source(args, use_native: bool, topic: "str | None" = None,
                seed_salt: int = 0) -> RecordSource:
    """The record source the flags select, for ``topic`` (``-t`` by
    default; a fan-in passes each of its topics with its index as the
    synthetic ``seed_salt``)."""
    topic = topic if topic is not None else args.topic
    if args.source != "kafka" and (
        args.on_corruption != "fail" or args.quarantine_dir
    ):
        raise ValueError(
            "--on-corruption/--quarantine-dir require --source kafka "
            "(only the wire scan can classify and re-fetch frames)"
        )
    if args.source != "segfile" and args.segment_cache:
        raise ValueError(
            "--segment-cache requires --source segfile (it caches chunks "
            "fetched from a remote segment store)"
        )
    if args.source == "segfile":
        if not args.segment_dir:
            raise SystemExit(
                "--source segfile requires --segment-dir (a local "
                "directory of .ktaseg dumps, or a remote store spec like "
                "http(s)://host:port/bucket or s3://bucket/prefix)"
            )
        fetch = SegmentFetchConfig.parse(
            readahead=args.segment_readahead,
            cache_dir=args.segment_cache,
            cache_max_bytes=args.segment_cache_bytes,
            fetch_concurrency=args.fetch_concurrency,
        )
        # The remote tier runs the wire scan's retry substrate, so the
        # same --librdkafka knobs tune it (retry.backoff.ms,
        # reconnect.backoff.max.ms, transport.retry.budget).
        retry_overrides = parse_kv_pairs(args.librdkafka)
        if retry_overrides:
            fetch = dataclasses.replace(
                fetch, retry=TransportRetryConfig.from_overrides(retry_overrides)
            )
        return SegmentFileSource(args.segment_dir, topic=topic, fetch=fetch)
    if args.source == "synthetic":
        spec = SyntheticSpec.from_kv(parse_kv_pairs(args.synthetic), seed_salt)
        if use_native:
            return native.NativeSyntheticSource(spec)
        return SyntheticSource(spec)
    if not args.bootstrap_server:
        raise SystemExit("--source kafka requires -b/--bootstrap-server")
    overrides = parse_kv_pairs(args.librdkafka)
    if args.check_crcs:
        # The explicit flag wins over a --librdkafka check.crcs override.
        overrides["check.crcs"] = "true"
    corruption = None
    if args.on_corruption != "fail" or args.quarantine_dir:
        corruption = CorruptionConfig(
            policy=args.on_corruption, quarantine_dir=args.quarantine_dir
        )
    data_loss = None
    if args.on_data_loss != "report":
        data_loss = DataLossConfig(policy=args.on_data_loss)
    return KafkaWireSource(
        bootstrap_servers=args.bootstrap_server,
        topic=topic,
        overrides=overrides,
        use_native_hashing=use_native,
        # None lets a --librdkafka on.corruption/quarantine.dir (or
        # on.data.loss) override apply; explicit flags win.
        corruption=corruption,
        data_loss=data_loss,
    )


def wrap_with_dump(args, source: RecordSource,
                   topic: "str | None" = None) -> RecordSource:
    """The source behind a segment-dump tee when --dump-segments is set
    (``topic``'s dump; ``-t`` by default)."""
    if not args.dump_segments:
        return source
    if args.resume:
        raise ValueError(
            "--dump-segments cannot be combined with --resume (the dump "
            "would miss already-scanned records); drop --resume — or "
            "delete the snapshot — so the dump scan covers the topic "
            "from its earliest offset"
        )
    return TeeSource(
        source,
        SegmentDumpWriter(
            args.dump_segments, topic if topic is not None else args.topic
        ),
    )


def resolve_ingest_workers(args, num_partitions: int) -> "int | IngestConfig":
    """--ingest-workers → the concrete worker count after 'auto' and the
    partition-count clamp; raises ValueError on a bad spec.  Under a mesh
    (``--mesh`` other than 1) the parsed `config.IngestConfig` comes back
    unresolved: the engine resolves it per controller, against the
    partitions of the data rows it feeds, and splits it over them."""
    cfg = IngestConfig.parse(args.ingest_workers)
    if parse_mesh(args.mesh) != (1, 1):
        return cfg
    return cfg.resolve(num_partitions)


def make_cli_backend(args, config: AnalyzerConfig, use_native: bool,
                     dispatch) -> MetricBackend:
    """The numpy oracle, the torch backend on one device, or, under a mesh
    on a device backend, `parallel.sharded.ShardedTorchBackend` (on every
    visible CUDA device, or the host under ``--device cpu``); raises
    ValueError on a mesh shape the sharded backend cannot run."""
    if args.backend != "cpu" and tuple(config.mesh_shape) != (1, 1):
        from kafka_topic_analyzer_tpu_torch.parallel.sharded import (
            ShardedTorchBackend,
        )

        return ShardedTorchBackend(
            config, device=args.device, use_native=use_native,
            native_requested=args.native != "off", dispatch=dispatch,
        )
    return make_backend(
        args.backend, config, device=args.device, use_native=use_native,
        native_requested=args.native != "off", dispatch=dispatch,
    )


def resolve_dispatch(args) -> "DispatchConfig | None":
    """--superbatch/--dispatch-depth → the torch backend's
    `config.DispatchConfig`, or None for the numpy oracle, which has no
    device dispatch to amortize: an explicit K > 1 there is refused (the
    reference's message), ``auto`` resolves to no superbatching."""
    cfg = DispatchConfig.parse(args.superbatch, args.dispatch_depth)
    if args.backend == "cpu":
        if cfg.superbatch != "auto" and int(cfg.superbatch) > 1:
            raise ValueError(
                "--superbatch requires --backend tpu (the cpu oracle has "
                "no device dispatch to amortize)"
            )
        return None
    return cfg


def parse_mesh(text: str) -> "tuple[int, int]":
    """--mesh → (data, space) device counts; raises ValueError on a bad
    spec (the reference's messages)."""
    try:
        parts = [int(x) for x in text.split(",") if x]
    except ValueError:
        raise ValueError(
            f"bad --mesh {text!r}: expected DATA or DATA,SPACE device "
            "counts (integers, e.g. '4' or '4,2')"
        ) from None
    if len(parts) not in (1, 2):
        raise ValueError(
            f"bad --mesh {text!r}: expected 1 or 2 comma-separated device "
            f"counts, got {len(parts)}"
        )
    if any(p < 1 for p in parts):
        raise ValueError(f"bad --mesh {text!r}: device counts must be positive")
    return (parts[0], parts[1] if len(parts) == 2 else 1)


def analyzer_config(args, num_partitions: int) -> AnalyzerConfig:
    """The `config.AnalyzerConfig` the flags ask for over
    ``num_partitions`` state rows."""
    return AnalyzerConfig(
        num_partitions=num_partitions,
        batch_size=args.batch_size,
        count_alive_keys=args.count_alive_keys,
        alive_bitmap_bits=args.alive_bitmap_bits,
        enable_hll=args.distinct_keys,
        distinct_keys_per_partition=args.distinct_keys_per_partition,
        enable_quantiles=args.quantiles,
        quantiles_per_partition=args.quantiles_per_partition,
        use_pallas_counters=args.pallas,
        wire_format=resolve_wire_format(args),
        alive_compaction=args.alive_compaction,
        mesh_shape=parse_mesh(args.mesh),
    )


def setup(args) -> "tuple[RecordSource, AnalyzerConfig, bool]":
    """Source, config and the resolved ``--native`` from parsed flags;
    raises ValueError on a bad flag value."""
    if args.dispatch_depth < 1:
        raise ValueError("dispatch depth must be >= 1")
    use_native = resolve_native(args)
    source = wrap_with_dump(args, make_source(args, use_native))
    return source, analyzer_config(args, len(source.partitions())), use_native


def resolve_start_offsets(source, from_ts_ms, label):
    """(start_at, exhausted): per-partition first offsets at or after the
    cutoff from the broker's timestamp index; exhausted=True (with the
    message printed) when nothing remains at or after it."""
    if from_ts_ms is None:
        return None, False
    start_at = source.offsets_for_timestamp(from_ts_ms)
    _, end = source.watermarks()
    if all(start_at.get(p, 0) >= end[p] for p in end):
        print(
            f"No records at or after {label} — nothing to analyze.",
            file=sys.stderr,
        )
        return None, True
    return start_at, False


def scan_issue_exit(result: ScanResult, doc: "dict | None" = None,
                    render: bool = False,
                    data_loss_policy: str = "report") -> int:
    """Surface what the scan booked — into ``doc`` as the str-keyed
    ``corrupt_partitions``/``degraded_partitions``/``data_loss`` maps
    (``--json``) and/or, with ``render``, as the warning blocks after the
    report (data loss unless ignored, corrupt frames, degraded
    partitions) — and pick the exit status: degraded wins over
    corrupt."""
    rc = 0
    if doc is not None:
        attach_issue_blocks(doc, result)
    if result.lost_partitions and render and data_loss_policy != "ignore":
        sys.stdout.write(render_data_loss_block(result.lost_partitions))
    if result.corrupt_partitions:
        if render:
            sys.stdout.write(render_corrupt_block(result.corrupt_partitions))
        rc = EXIT_CORRUPT
    if result.degraded_partitions:
        if render:
            sys.stdout.write(render_degraded_block(result.degraded_partitions))
        rc = EXIT_DEGRADED
    return rc


def print_stats(result: ScanResult, diagnosis) -> None:
    """``--stats`` stderr digest: the stage timings and the telemetry
    counters from the scan's registry snapshot, then the scan doctor's
    BOTTLENECK verdict (``diagnosis``, from the same snapshot plus the
    flight recorder's series when one runs), then the HEALTH and TRENDS
    digests."""
    sys.stderr.write(render_stage_stats(result.telemetry))
    sys.stderr.write(
        render_telemetry_stats(
            result.telemetry,
            ingest_workers=result.ingest_workers,
            superbatch_k=result.superbatch_k,
            dispatch_depth=result.dispatch_depth,
            wire=result.wire,
            ingest_workers_per_controller=result.ingest_workers_per_controller,
        )
    )
    sys.stderr.write(render_bottleneck(diagnosis))
    print_health_stats()


def print_health_stats() -> None:
    """``--stats`` HEALTH + TRENDS digests: the alert engine's latest
    document, and the trend doctor's findings over the history window
    when ``--history-bytes`` ran."""
    sys.stderr.write(render_health(health_doc()))
    store = obs_history.active()
    if store is not None:
        from kafka_topic_analyzer_tpu_torch.obs.doctor import diagnose_trends

        sys.stderr.write(render_trends(diagnose_trends(store.window())))


def health_doc() -> "dict | None":
    """The active alert engine's latest document — the ``health`` block of
    ``--json`` and the HEALTH digest — or None when no engine runs (no
    ``--metrics-port`` or history).  A scan shorter than the engine's
    interval never reached a heartbeat boundary, so one evaluation runs
    here: a missing block would read as "alerting never ran"."""
    engine = obs_health.active()
    if engine is None:
        return None
    if engine.doc() is None:
        engine.evaluate()
    return engine.doc()


def validate_routing(args) -> None:
    """Refuse the flag combinations the port cannot run, before any
    broker handshake or dump directory creation."""
    if args.instance_id:
        raise ValueError(
            "--instance-id requires the fleet scheduler (topic "
            "ownership leases arbitrate WHOLE topics between "
            "analyzer instances; a solo or batch fan-in scan has "
            "no admission to arbitrate) — add --fleet, or --follow "
            "with a multi-topic list"
        )
    if args.follow and args.source == "segfile":
        raise ValueError(
            "--follow cannot tail --source segfile (a segment store "
            "is immutable — there is no moving head to poll); run "
            "the batch scan of the store, or --follow the live "
            "topic with --source kafka (add --dump-segments to keep "
            "the archive fresh)"
        )


def scan_session(args, open_source, start, banner: str, scan):
    """The steps `run` and `run_multi_topic` share, in order: the flags
    every scan reads; ``open_source(use_native)`` builds the source;
    ``start(source, from_ts_ms)`` gives ``(start_at, rc)``, rc an exit
    status for an empty or exhausted topic (the two paths check these in
    the reference's two orders); the backend and the ``banner`` lines;
    ``scan(source, backend, start_at, ingest_workers)`` under the
    profiler, which returns the result or None once it printed why it
    refused to start; then the doctor's diagnosis and ``--stats``.
    Returns ``(rc, result, diagnosis)``, rc None when the scan ran; the
    source is closed on every way out."""
    source = None
    try:
        try:
            from_ts_ms = parse_from_timestamp_flag(args)
            dispatch = resolve_dispatch(args)
            if args.dispatch_depth < 1:
                raise ValueError("dispatch depth must be >= 1")
            use_native = resolve_native(args)
            source = open_source(use_native)
            config = analyzer_config(args, len(source.partitions()))
            ingest_workers = resolve_ingest_workers(args, config.num_partitions)
            start_at, rc = start(source, from_ts_ms)
            if rc is None:
                backend = make_cli_backend(args, config, use_native, dispatch)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1, None, None
        if rc is not None:
            return rc, None, None
        banner_out = (
            sys.stderr if args.json or not_report_process(args) else sys.stdout
        )
        print(banner, file=banner_out)
        print("Starting message consumption...", file=banner_out)
        with maybe_torch_trace(args.profile_dir, backend.device):
            result = scan(source, backend, start_at, ingest_workers)
        if result is None:
            return 1, None, None
        # Only the --stats digest and the --json flight block read the
        # doctor's diagnosis; the plain report skips the pass.
        diagnosis = None
        if args.stats or args.json:
            from kafka_topic_analyzer_tpu_torch.obs.doctor import diagnose_scan

            diagnosis = diagnose_scan(result)
        if args.stats:
            print_stats(result, diagnosis)
        return None, result, diagnosis
    except DataLossError as e:
        # --on-data-loss fail: the loss is booked and, with
        # --snapshot-dir, the engine wrote a fold-consistent checkpoint
        # on the way out, so the distinct exit code tells automation a
        # --resume will continue past the named gap.
        print(f"error: DATA-LOSS: {e}", file=sys.stderr)
        return EXIT_DATA_LOSS, None, None
    except (OSError, KafkaProtocolError) as e:
        # A broker or file fault, or a damaged frame or dump: one line,
        # as the reference prints it.
        print(f"error: {e}", file=sys.stderr)
        return 1, None, None
    finally:
        if source is not None and hasattr(source, "close"):
            source.close()  # flush segment dumps, release broker connections


def not_report_process(args) -> bool:
    """Whether this process prints no report: under ``--distributed``
    every process scans and merges, and process 0 alone reports."""
    return bool(args.distributed) and process_index() != 0


def batch_scan(args):
    """The ``scan`` of `scan_session` for a batch scan."""
    def scan(source, backend, start_at, ingest_workers):
        return run_scan(
            args.topic, source, backend, args.batch_size,
            start_at=start_at, spinner=Spinner(enabled=not args.quiet),
            snapshot_dir=args.snapshot_dir,
            snapshot_every_s=args.snapshot_every,
            resume=args.resume,
            ingest_workers=ingest_workers,
        )
    return scan


def run(args) -> "tuple[int, ScanResult | None]":
    """One scan (or follow service) from parsed flags: the report and its
    warning blocks go to stdout, errors to stderr.  Returns the exit
    status and the scan's result (None when no scan ran).  ``-t a,b,c``
    goes to `run_multi_topic`; ``--fleet`` and ``-t a,b --follow`` go to
    `run_fleet`, whose result is a `fleet.service.FleetResult`.  Under
    ``--distributed`` the process group is joined first."""
    if args.distributed:
        try:
            initialize_distributed(args.distributed)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1, None
    if args.fleet:
        return run_fleet(args)
    # Kafka topic names cannot contain commas: an explicit topic list
    # under --follow runs through the fleet scheduler (each topic keeps
    # its solo pass chain; the budgets are shared).
    if "," in args.topic and args.follow:
        return run_fleet(args, topics=[t for t in args.topic.split(",") if t])
    try:
        validate_routing(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1, None
    # Kafka topic names cannot contain commas, so "-t a,b,c" unambiguously
    # selects the multi-topic fan-in.
    if "," in args.topic:
        return run_multi_topic(args, [t for t in args.topic.split(",") if t])

    def start(source, from_ts_ms):
        start_at, exhausted = resolve_start_offsets(
            source, from_ts_ms, args.from_timestamp
        )
        if exhausted:
            return None, 0
        # A follow service skips the empty-topic guard: waiting on a
        # still-empty topic for its first record is the job.
        if source.is_empty() and not args.follow:
            print(
                "Given topic has no content, no analysis possible. Exiting.",
                file=sys.stderr,
            )
            return None, EXIT_EMPTY_TOPIC
        return start_at, None

    follow_service = None

    def follow(source, backend, start_at, ingest_workers):
        nonlocal follow_service
        try:
            follow_service = make_follow_service(
                args, source, backend, start_at, ingest_workers
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return None
        restore_signals = follow_service.install_signal_handlers()
        try:
            return follow_service.run()
        finally:
            restore_signals()

    rc, result, diagnosis = scan_session(
        args,
        lambda use_native: wrap_with_dump(args, make_source(args, use_native)),
        start,
        f"Subscribing to {args.topic}",
        follow if args.follow else batch_scan(args),
    )
    if rc is not None:
        return rc, None
    if not_report_process(args):
        # One report, from process 0; the exit status is agreed.
        return scan_issue_exit(result), result
    if args.json:
        doc = build_json_doc(
            args.topic,
            result,
            diagnosis=diagnosis,
            follow=(
                follow_service.follow_block()
                if follow_service is not None else None
            ),
            windows=(
                follow_service.windows_report()
                if follow_service is not None else None
            ),
            health=health_doc(),
        )
        rc = scan_issue_exit(result, doc=doc)
        print(json.dumps(doc))
        return rc, result
    sys.stdout.write(
        render_report(
            args.topic,
            result.metrics,
            result.start_offsets,
            result.end_offsets,
            result.duration_secs,
            show_alive_keys=args.count_alive_keys,
        )
    )
    if args.extremes_table:
        sys.stdout.write(render_extremes_table(result.metrics))
    return scan_issue_exit(
        result, render=True, data_loss_policy=args.on_data_loss
    ), result


def make_follow_service(args, source, backend, start_at, ingest_workers):
    """The `serve.follow.FollowService` the ``--follow`` flags ask for;
    raises ValueError on a bad flag value."""
    from kafka_topic_analyzer_tpu_torch.config import FollowConfig
    from kafka_topic_analyzer_tpu_torch.serve.follow import FollowService

    follow_cfg = FollowConfig(
        poll_interval_s=args.poll_interval,
        checkpoint_every_s=(
            args.checkpoint_interval
            if args.checkpoint_interval is not None
            else args.snapshot_every
        ),
        idle_exit_s=args.follow_idle_exit,
        window_secs=args.window_secs,
        window_count=args.window_count,
    )
    return FollowService(
        args.topic,
        source,
        backend,
        batch_size=args.batch_size,
        follow=follow_cfg,
        spinner=Spinner(enabled=not args.quiet),
        snapshot_dir=args.snapshot_dir,
        resume=args.resume,
        start_at=start_at,
        ingest_workers=ingest_workers,
        # /report.json assembly is pure waste when no HTTP server exists
        # to serve it.
        publish_reports=args.metrics_port is not None,
        serve_gzip=not args.no_serve_gzip,
    )


def run_multi_topic(args, topics: "list[str]") -> "tuple[int, ScanResult | None]":
    """Fan-in scan of several topics through one backend: per-topic
    reports from row slices, plus a cross-topic union block whose sketch
    lines come from the associatively merged state (io/multi.py)."""
    from kafka_topic_analyzer_tpu_torch.io.multi import MultiTopicSource
    from kafka_topic_analyzer_tpu_torch.results import slice_rows
    from kafka_topic_analyzer_tpu_torch.utils.timefmt import format_utc_seconds

    multi = None

    def open_source(use_native):
        nonlocal multi
        # Dump tees attach per topic, before the fan-in remaps ids.
        multi = MultiTopicSource([
            (t, wrap_with_dump(
                args, make_source(args, use_native, topic=t, seed_salt=i), t
            ))
            for i, t in enumerate(topics)
        ])
        return multi

    def start(source, from_ts_ms):
        if source.is_empty():
            print(
                "Given topic has no content, no analysis possible. Exiting.",
                file=sys.stderr,
            )
            return None, EXIT_EMPTY_TOPIC
        start_at, exhausted = resolve_start_offsets(
            source, from_ts_ms, args.from_timestamp
        )
        return start_at, 0 if exhausted else None

    rc, result, diagnosis = scan_session(
        args, open_source, start,
        f"Subscribing to {', '.join(topics)} ({len(topics)}-topic fan-in)",
        batch_scan(args),
    )
    if rc is not None:
        return rc, None
    if not_report_process(args):
        return scan_issue_exit(result), result

    union = result.metrics
    # Per-topic projections, computed once for both output formats.
    slices = []
    for topic in topics:
        rows = multi.rows_for(topic)
        ids = [multi.true_partition(r) for r in rows]
        sliced = slice_rows(union, rows, ids)
        start = {multi.true_partition(r): result.start_offsets[r] for r in rows}
        end = {multi.true_partition(r): result.end_offsets[r] for r in rows}
        slices.append((topic, sliced, start, end))

    if args.json:
        doc: dict = {
            "topics": {},
            "duration_secs": result.duration_secs,
            "ingest_workers": result.ingest_workers,
            "ingest_workers_per_controller": result.ingest_workers_per_controller,
            "superbatch_k": result.superbatch_k,
            "dispatch_depth": result.dispatch_depth,
        }
        for topic, sliced, start, end in slices:
            doc["topics"][topic] = sliced.to_dict(start, end)
        union_doc = {
            "count": union.overall_count,
            "size_bytes": union.overall_size,
            "earliest_ts": union.earliest_ts_s,
            "latest_ts": union.latest_ts_s,
        }
        if union.alive_keys is not None:
            union_doc["alive_keys_sum_over_topics"] = union.alive_keys
        if union.distinct_keys_hll is not None:
            union_doc["distinct_keys_hll"] = union.distinct_keys_hll
        if union.distinct_keys_exact is not None:
            union_doc["distinct_keys_exact"] = union.distinct_keys_exact
        if union.quantiles is not None:
            union_doc["size_quantiles"] = union.quantiles.as_dict()
        doc["union"] = union_doc
        doc["telemetry"] = result.telemetry
        attach_scan_digests(doc, result, diagnosis)
        # Degraded keys are dense fan-in rows; reasons carry topic/partition.
        rc = scan_issue_exit(result, doc=doc)
        print(json.dumps(doc))
        return rc, result
    for topic, sliced, start, end in slices:
        # Only the per-row lines a slice can carry render (per-partition
        # sketches); the merged union-only sketches are None here.
        sys.stdout.write(
            render_report(
                topic, sliced, start, end, result.duration_secs,
                show_alive_keys=False, show_extensions=True,
            )
        )
        if args.extremes_table:
            sys.stdout.write(render_extremes_table(sliced))
    # Union block: totals + merged sketches (not sliceable per topic).
    eq = "=" * 120
    print(eq)
    print(f"FAN-IN UNION of {len(topics)} topics: {', '.join(topics)}")
    print(f"Messages: {union.overall_count}")
    print(f"Bytes: {union.overall_size}")
    print(f"Earliest Message: {format_utc_seconds(union.earliest_ts_s)}")
    print(f"Latest Message: {format_utc_seconds(union.latest_ts_s)}")
    if args.count_alive_keys and union.alive_keys is not None:
        # Sum of per-topic alive keys (slots are salted per topic, so the
        # count is interleaving-independent; io/multi.py).
        print(f"Alive keys (sum over topics): {union.alive_keys}")
    if union.distinct_keys_hll is not None:
        print(f"Distinct keys (HLL est., union): {round(union.distinct_keys_hll)}")
    if union.distinct_keys_exact is not None:
        print(f"Distinct keys (exact, union): {union.distinct_keys_exact}")
    if union.quantiles is not None:
        qs = " ".join(
            f"p{int(p * 100)}={v:.0f}B"
            for p, v in zip(union.quantiles.probs, union.quantiles.values)
        )
        print(f"Message size quantiles (union): {qs}")
    print(eq)
    return scan_issue_exit(
        result, render=True, data_loss_policy=args.on_data_loss
    ), result


def fleet_exit(fleet_result) -> int:
    """A fleet's exit status: the solo scan's precedence (degraded over
    corrupt over data loss) with one rung above them all, a topic whose
    scan failed (isolation caught it; its numbers are partial)."""
    if fleet_result.any_failed:
        return 1
    if fleet_result.any_degraded:
        return EXIT_DEGRADED
    if fleet_result.any_corrupt:
        return EXIT_CORRUPT
    if fleet_result.any_data_loss:
        return EXIT_DATA_LOSS
    return 0


def make_lease_manager(cfg, snapshot_dir=None, store_spec=None):
    """A `fleet.lease.LeaseManager` for a `config.LeaseConfig`: ``object``
    leases ride the remote segment store's ETag-fenced conditional
    writes, ``file`` leases atomic renames under the checkpoint directory,
    and ``auto`` picks ``object`` exactly when ``store_spec`` (the
    ``--segment-dir``) is remote.  Raises ValueError when the chosen
    store has nowhere to live."""
    import re

    from kafka_topic_analyzer_tpu_torch.fleet.lease import (
        FileLeaseStore,
        LeaseManager,
        ObjectLeaseStore,
    )
    from kafka_topic_analyzer_tpu_torch.io.retry import Backoff

    remote = bool(store_spec and re.match(r"^(https?|s3)://", str(store_spec)))
    choice = cfg.store
    if choice == "auto":
        choice = "object" if remote else "file"
    if choice == "object":
        if not remote:
            raise ValueError(
                "--lease-store object needs a remote --segment-dir spec "
                "(http://, https://, s3://) to host the lease records"
            )
        from kafka_topic_analyzer_tpu_torch.io.objstore import RetryingHttp

        store = ObjectLeaseStore(
            RetryingHttp(str(store_spec), SegmentFetchConfig())
        )
    else:
        if not snapshot_dir:
            raise ValueError(
                "--instance-id needs a lease store: pass --snapshot-dir "
                "(file leases live in SNAPSHOT_DIR/_kta_leases/) or a "
                "remote --segment-dir spec with --lease-store object"
            )
        store = FileLeaseStore(snapshot_dir)
    return LeaseManager(
        store,
        instance=cfg.instance_id,
        ttl_s=cfg.ttl_s,
        backoff=Backoff(TransportRetryConfig()),
    )


def fleet_plan(args):
    """The flags `run_fleet` reads before any broker handshake: (dispatch
    config or None, ingest config, explicit concurrency or None, follow
    config or None).  Raises ValueError on a refused combination or a bad
    value (the reference's messages)."""
    from kafka_topic_analyzer_tpu_torch.config import FollowConfig

    if args.source != "kafka":
        raise ValueError(
            "--fleet requires --source kafka (discovery reads cluster "
            "metadata); a segment store is one topic's immutable "
            "archive with no topic list or moving head — scan it solo "
            "with --source segfile (synthetic sources scan solo too)"
        )
    if not args.bootstrap_server:
        raise SystemExit("--fleet requires -b/--bootstrap-server")
    if parse_mesh(args.mesh) != (1, 1):
        raise ValueError(
            "--fleet does not support --mesh yet (fleet scans run "
            "per-topic single-device backends); drop --mesh, or scan "
            "one topic solo to use a device mesh"
        )
    if args.distributed:
        raise ValueError(
            "--fleet does not support --distributed (per-poll "
            "admission would need fleet-wide lockstep agreement); "
            "run the fleet single-controller"
        )
    if args.dump_segments:
        raise ValueError(
            "--fleet does not support --dump-segments (the dump tee "
            "is single-topic); run a solo scan with --dump-segments "
            "per topic instead"
        )
    if args.from_timestamp:
        raise ValueError(
            "--fleet does not support --from-timestamp yet (the "
            "cutoff would need a per-topic seek); scan the topic "
            "solo with --from-timestamp instead"
        )
    dispatch = resolve_dispatch(args)
    if args.dispatch_depth < 1:
        raise ValueError("dispatch depth must be >= 1")
    ingest_cfg = IngestConfig.parse(args.ingest_workers)
    concurrency = None
    text = str(args.fleet_concurrency).strip().lower()
    if text != "auto":
        try:
            concurrency = int(text)
        except ValueError:
            raise ValueError(
                f"bad --fleet-concurrency {args.fleet_concurrency!r}: "
                "expected a positive integer or 'auto'"
            ) from None
        if concurrency < 1:
            raise ValueError("--fleet-concurrency must be >= 1")
    follow_cfg = None
    if args.follow:
        follow_cfg = FollowConfig(
            poll_interval_s=args.poll_interval,
            checkpoint_every_s=(
                args.checkpoint_interval
                if args.checkpoint_interval is not None
                else args.snapshot_every
            ),
            idle_exit_s=args.follow_idle_exit,
        )
    return dispatch, ingest_cfg, concurrency, follow_cfg


def run_fleet(args, topics: "list[str] | None" = None):
    """Cluster-wide scan (``--fleet``), or an explicit multi-topic follow
    (``-t a,b --follow``: ``topics`` pins the list and skips discovery).
    Every topic keeps its solo pass chain on a backend of its own (on the
    card, on a CUDA stream of its own); the fleet scheduler shares the
    ``--ingest-workers`` and ``--dispatch-depth`` budgets.  Prints each
    topic's report and the status table (or the rollup document with the
    per-topic documents under ``--json``); returns ``(exit status,
    fleet.service.FleetResult or None)``."""
    from kafka_topic_analyzer_tpu_torch.config import LeaseConfig
    from kafka_topic_analyzer_tpu_torch.fleet.discovery import (
        discover_topics,
        parse_globs,
    )
    from kafka_topic_analyzer_tpu_torch.fleet.scheduler import (
        FleetScheduler,
        TopicSeed,
    )
    from kafka_topic_analyzer_tpu_torch.fleet.service import FleetService
    from kafka_topic_analyzer_tpu_torch.obs.doctor import diagnose_scan
    from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
    from kafka_topic_analyzer_tpu_torch.report import render_fleet_status

    try:
        dispatch, ingest_cfg, explicit_concurrency, follow_cfg = fleet_plan(args)
        use_native = resolve_native(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1, None

    banner_out = sys.stderr if args.json else sys.stdout
    rediscover = None
    if topics is None:
        include = parse_globs(args.topic) or ["*"]
        exclude = parse_globs(args.fleet_exclude)

        def discover() -> "list[TopicSeed]":
            return [
                TopicSeed(name=d.name, partitions=d.partitions)
                for d in discover_topics(
                    args.bootstrap_server, include, exclude, args.fleet_internal,
                )
            ]

        try:
            seeds = discover()
        except (OSError, KafkaProtocolError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1, None
        if args.follow:
            rediscover = discover
        print(
            f"Fleet discovery: {len(seeds)} topic(s) matched "
            f"{','.join(include)}"
            + (f" minus {','.join(exclude)}" if exclude else ""),
            file=banner_out,
        )
    else:
        # The worker budget is resolved against the real partition counts
        # (one all-topics metadata round trip); an unreachable cluster
        # keeps placeholders of 1, and every scan then fails in isolation.
        parts_by_name: "dict[str, int]" = {}
        try:
            wanted = set(topics)
            for d in discover_topics(args.bootstrap_server, include_internal=True):
                if d.name in wanted:
                    parts_by_name[d.name] = d.partitions
        except Exception as e:
            print(
                f"warning: could not size the fleet from cluster "
                f"metadata ({e}); worker budget assumes 1 partition "
                "per topic",
                file=sys.stderr,
            )
        seeds = [
            TopicSeed(name=t, partitions=parts_by_name.get(t, 1)) for t in topics
        ]
    if not seeds:
        print(
            "No topics matched the fleet filters, no analysis possible. "
            "Exiting.",
            file=sys.stderr,
        )
        return EXIT_EMPTY_TOPIC, None

    total_parts = sum(max(1, s.partitions) for s in seeds)
    worker_budget = ingest_cfg.resolve(max(1, total_parts))
    max_concurrent = (
        explicit_concurrency
        if explicit_concurrency is not None
        else max(1, min(4, len(seeds), worker_budget))
    )
    # --dispatch-depth is the GLOBAL in-flight budget the concurrent
    # device scans share (each admitted scan holds at least one token),
    # under every device backend (gpu, and tpu, its reference spelling);
    # the oracle has no dispatch queue, so its budget is the concurrency.
    dispatch_budget = (
        max(1, args.dispatch_depth) if dispatch is not None else max_concurrent
    )
    on_card = args.backend != "cpu" and args.device == "cuda"

    def source_factory(topic: str):
        return make_source(args, use_native, topic=topic)

    def backend_factory(topic: str, num_partitions: int, grant):
        topic_dispatch = None
        if dispatch is not None:
            topic_dispatch = DispatchConfig(
                superbatch=dispatch.superbatch, depth=grant.dispatch_depth
            )
        # A stream of the topic's own, leased from the process's pool: the
        # folds of concurrent topics are ordered only within their topic.
        return make_backend(
            args.backend, analyzer_config(args, num_partitions),
            device=args.device, use_native=use_native,
            native_requested=args.native != "off", dispatch=topic_dispatch,
            pooled_stream=on_card,
        )

    lease_mgr = None
    instance = "solo"
    if args.instance_id:
        instance = args.instance_id
        if instance == "auto":
            # Bare --instance-id: HOSTNAME-PID is unique per process.
            import os
            import socket

            instance = f"{socket.gethostname()}-{os.getpid()}"
        try:
            lease_mgr = make_lease_manager(
                LeaseConfig(
                    instance_id=instance, ttl_s=args.lease_ttl,
                    store=args.lease_store,
                ),
                snapshot_dir=args.snapshot_dir,
                store_spec=args.segment_dir,
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1, None

    scheduler = FleetScheduler(
        worker_budget, dispatch_budget, max_concurrent, instance=instance
    )
    svc = FleetService(
        seeds,
        source_factory,
        backend_factory,
        args.batch_size,
        scheduler,
        follow=follow_cfg,
        snapshot_dir=args.snapshot_dir,
        resume=args.resume,
        # /report.json assembly is waste when no HTTP server serves it.
        publish_reports=args.metrics_port is not None,
        serve_gzip=not args.no_serve_gzip,
        spinner=Spinner(enabled=not args.quiet),
        rediscover=rediscover,
        leases=lease_mgr,
        instance=instance,
    )
    print(
        f"Fleet scan of {len(seeds)} topic(s): "
        f"{worker_budget} worker(s), dispatch budget {dispatch_budget}, "
        f"concurrency {max_concurrent}"
        + (" (follow)" if args.follow else "")
        + (
            f" [instance {instance}, lease TTL {args.lease_ttl:g}s]"
            if lease_mgr is not None else ""
        ),
        file=banner_out,
    )
    with maybe_torch_trace(args.profile_dir, "cuda" if on_card else None):
        if args.follow:
            restore = svc.install_signal_handlers()
            try:
                fleet_result = svc.run_follow()
            finally:
                restore()
        else:
            fleet_result = svc.run_batch()

    if args.stats:
        sys.stderr.write(render_fleet_status(fleet_result.rollup))
        sys.stderr.write(render_telemetry_stats(default_registry().snapshot()))
        print_health_stats()
    rc = fleet_exit(fleet_result)
    if args.json:
        doc = dict(fleet_result.rollup)
        doc["topics"] = {
            t: build_json_doc(
                t,
                result,
                diagnosis=diagnose_scan(result),
                fleet=fleet_result.statuses[t].as_dict(),
            )
            for t, result in sorted(fleet_result.results.items())
        }
        print(json.dumps(doc))
        return rc, fleet_result
    for t, result in sorted(fleet_result.results.items()):
        sys.stdout.write(
            render_report(
                t,
                result.metrics,
                result.start_offsets,
                result.end_offsets,
                result.duration_secs,
                show_alive_keys=args.count_alive_keys,
            )
        )
    sys.stdout.write(render_fleet_status(fleet_result.rollup))
    return rc, fleet_result


def main(argv: "list[str] | None" = None) -> int:
    init_logging()  # env_logger parity: RUST_LOG / KTA_LOG
    args = build_parser().parse_args(argv)
    history_dir = None
    if args.history_bytes:
        if args.history_bytes < 4096:
            print("error: --history-bytes must be >= 4096", file=sys.stderr)
            return 1
        if not args.snapshot_dir:
            print(
                "error: --history-bytes requires --snapshot-dir (the "
                "telemetry history lives next to the checkpoints so a "
                "restarted service resumes both from one place)",
                file=sys.stderr,
            )
            return 1
        from kafka_topic_analyzer_tpu_torch.checkpoint import (
            history_dir as _history_dir,
        )

        history_dir = _history_dir(args.snapshot_dir)
    try:
        with telemetry_session(
            metrics_port=args.metrics_port,
            events_jsonl=args.events_jsonl,
            trace_json=args.trace_json,
            flight_record=args.flight_record,
            history_dir=history_dir,
            history_bytes=args.history_bytes,
            sse=args.sse,
        ):
            return run(args)[0]
    except OSError as e:
        # A bad --trace-json/--events-jsonl path or a busy --metrics-port.
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        shutdown_distributed()
