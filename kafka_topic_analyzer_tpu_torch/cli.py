"""Command line of the port: the Kafka wire, synthetic and segment-file
batch scans (port of the reference's ``cli.py``, the flags of the ported
single-scan paths).

    python -m kafka_topic_analyzer_tpu_torch -t T \\
        ([--source kafka] -b HOST:PORT [--librdkafka K=V,...] \\
         | --source synthetic --synthetic SPEC \\
         | --source segfile --segment-dir DIR) \\
        [-c] [--distinct-keys] [--distinct-keys-per-partition] \\
        [--quantiles] [--quantiles-per-partition] [--extremes-table] \\
        [--pallas] [--batch-size B] [--alive-bitmap-bits N] \\
        [--wire-format auto|v4|v5] [--alive-compaction auto|off] \\
        [--native auto|on|off] [--backend gpu|tpu|cpu] [--device cuda|cpu] \\
        [--dispatch-depth D] [--ingest-workers N|auto] \\
        [--snapshot-dir DIR [--snapshot-every S] [--resume]] [--check-crcs] \\
        [--on-corruption fail|skip|quarantine] [--quarantine-dir DIR] \\
        [--on-data-loss fail|report|ignore] \\
        [--from-timestamp ISO8601|EPOCH_MS] [--dump-segments DIR] \\
        [--quiet] [--stats] [--profile-dir DIR] [--metrics-port PORT] \\
        [--events-jsonl FILE] [--trace-json FILE] [--flight-record]

Prints the same report bytes as the reference CLI for the same inputs
(apart from the two timing lines), with the reference's DEGRADED, CORRUPT
and DATA-LOSS blocks after it.  ``--source kafka`` (the default) reads the
topic over the Kafka wire protocol.

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
``--resume`` continues from, in this CLI or the reference's.  Exit
status: 254 for an empty topic (the reference's ``exit(-2)``), 1 for an
error, 3 when partitions degraded, 4 when corrupt frames were skipped, 5
when ``--on-data-loss fail`` aborted the scan (after its checkpoint, with
``--snapshot-dir``).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

from kafka_topic_analyzer_tpu_torch import __version__
from kafka_topic_analyzer_tpu_torch.backends.base import make_backend
from kafka_topic_analyzer_tpu_torch.config import (
    AnalyzerConfig,
    CorruptionConfig,
    DataLossConfig,
    IngestConfig,
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
from kafka_topic_analyzer_tpu_torch.obs import telemetry_session
from kafka_topic_analyzer_tpu_torch.report import (
    render_bottleneck,
    render_corrupt_block,
    render_data_loss_block,
    render_degraded_block,
    render_extremes_table,
    render_report,
    render_stage_stats,
    render_telemetry_stats,
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
    p.add_argument("--segment-dir", metavar="DIR",
                   help="Local directory (or file://DIR) of .ktaseg dumps "
                        "(--source segfile); remote stores are not yet "
                        "ported")
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
    p.add_argument("--dispatch-depth", type=int, default=2, metavar="D",
                   help="Folds allowed in flight while the device works; "
                        "the drive loop blocks (backpressuring ingest) "
                        "beyond it. Default: 2")
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
    p.add_argument("--events-jsonl", metavar="FILE",
                   help="Append structured scan lifecycle + transport-fault "
                        "events to FILE as JSON lines")
    p.add_argument("--trace-json", metavar="FILE",
                   help="Write a Chrome trace-event JSON of host-side scan "
                        "spans (fetch/decode/stages) to FILE; combine with "
                        "--profile-dir for the device timeline")
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


def make_source(args, use_native: bool) -> RecordSource:
    if args.source != "kafka" and (
        args.on_corruption != "fail" or args.quarantine_dir
    ):
        raise ValueError(
            "--on-corruption/--quarantine-dir require --source kafka "
            "(only the wire scan can classify and re-fetch frames)"
        )
    if args.source == "segfile":
        if not args.segment_dir:
            raise SystemExit(
                "--source segfile requires --segment-dir (a local "
                "directory of .ktaseg dumps, or a remote store spec like "
                "http(s)://host:port/bucket or s3://bucket/prefix)"
            )
        return SegmentFileSource(args.segment_dir, topic=args.topic)
    if args.source == "synthetic":
        spec = SyntheticSpec.from_kv(parse_kv_pairs(args.synthetic))
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
        topic=args.topic,
        overrides=overrides,
        use_native_hashing=use_native,
        # None lets a --librdkafka on.corruption/quarantine.dir (or
        # on.data.loss) override apply; explicit flags win.
        corruption=corruption,
        data_loss=data_loss,
    )


def wrap_with_dump(args, source: RecordSource) -> RecordSource:
    """The source behind a segment-dump tee when --dump-segments is set."""
    if not args.dump_segments:
        return source
    if args.resume:
        raise ValueError(
            "--dump-segments cannot be combined with --resume (the dump "
            "would miss already-scanned records); drop --resume — or "
            "delete the snapshot — so the dump scan covers the topic "
            "from its earliest offset"
        )
    return TeeSource(source, SegmentDumpWriter(args.dump_segments, args.topic))


def resolve_ingest_workers(args, num_partitions: int) -> int:
    """--ingest-workers → the concrete worker count after 'auto' and the
    partition-count clamp; raises ValueError on a bad spec."""
    return IngestConfig.parse(args.ingest_workers).resolve(num_partitions)


def setup(args) -> "tuple[RecordSource, AnalyzerConfig, bool]":
    """Source, config and the resolved ``--native`` from parsed flags;
    raises ValueError on a bad flag value."""
    if args.dispatch_depth < 1:
        raise ValueError("dispatch depth must be >= 1")
    use_native = resolve_native(args)
    source = wrap_with_dump(args, make_source(args, use_native))
    config = AnalyzerConfig(
        num_partitions=len(source.partitions()),
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
    )
    return source, config, use_native


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


def scan_issue_exit(result: ScanResult, data_loss_policy: str) -> int:
    """Print the warning blocks of what the scan booked (data loss, unless
    ignored; corrupt frames; degraded partitions) after the report, and
    pick the exit status: degraded wins over corrupt."""
    rc = 0
    if result.lost_partitions and data_loss_policy != "ignore":
        sys.stdout.write(render_data_loss_block(result.lost_partitions))
    if result.corrupt_partitions:
        sys.stdout.write(render_corrupt_block(result.corrupt_partitions))
        rc = EXIT_CORRUPT
    if result.degraded_partitions:
        sys.stdout.write(render_degraded_block(result.degraded_partitions))
        rc = EXIT_DEGRADED
    return rc


def print_stats(result: ScanResult) -> None:
    """``--stats`` stderr digest: the stage timings and the telemetry
    counters from the scan's registry snapshot, then the scan doctor's
    BOTTLENECK verdict from the same snapshot (plus the flight recorder's
    series when one runs)."""
    from kafka_topic_analyzer_tpu_torch.obs.doctor import diagnose_scan

    sys.stderr.write(render_stage_stats(result.telemetry))
    sys.stderr.write(
        render_telemetry_stats(
            result.telemetry,
            ingest_workers=result.ingest_workers,
            dispatch_depth=result.dispatch_depth,
            wire=result.wire,
        )
    )
    sys.stderr.write(render_bottleneck(diagnose_scan(result)))


def run(args) -> "tuple[int, ScanResult | None]":
    """One scan from parsed flags: the report and its warning blocks go to
    stdout, errors to stderr.  Returns the exit status and the scan's
    result (None when no scan ran)."""
    source = None
    try:
        try:
            from_ts_ms = parse_from_timestamp_flag(args)
            source, config, use_native = setup(args)
            ingest_workers = resolve_ingest_workers(args, config.num_partitions)
            start_at, exhausted = resolve_start_offsets(
                source, from_ts_ms, args.from_timestamp
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1, None
        if exhausted:
            return 0, None
        if source.is_empty():
            print(
                "Given topic has no content, no analysis possible. Exiting.",
                file=sys.stderr,
            )
            return EXIT_EMPTY_TOPIC, None
        backend = make_backend(
            args.backend, config, device=args.device, use_native=use_native,
            dispatch_depth=args.dispatch_depth,
            native_requested=args.native != "off",
        )
        print(f"Subscribing to {args.topic}")
        print("Starting message consumption...")
        with maybe_torch_trace(args.profile_dir, backend.device):
            result = run_scan(
                args.topic, source, backend, args.batch_size,
                start_at=start_at, spinner=Spinner(enabled=not args.quiet),
                snapshot_dir=args.snapshot_dir,
                snapshot_every_s=args.snapshot_every,
                resume=args.resume,
                ingest_workers=ingest_workers,
            )
        if args.stats:
            print_stats(result)
    except DataLossError as e:
        # --on-data-loss fail: the loss is booked and, with
        # --snapshot-dir, the engine wrote a fold-consistent checkpoint
        # on the way out, so the distinct exit code tells automation a
        # --resume will continue past the named gap.
        print(f"error: DATA-LOSS: {e}", file=sys.stderr)
        return EXIT_DATA_LOSS, None
    except (OSError, KafkaProtocolError) as e:
        # A broker or file fault, or a damaged frame or dump: one line,
        # as the reference prints it.
        print(f"error: {e}", file=sys.stderr)
        return 1, None
    finally:
        if source is not None and hasattr(source, "close"):
            source.close()  # flush segment dumps, release broker connections
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
    return scan_issue_exit(result, args.on_data_loss), result


def main(argv: "list[str] | None" = None) -> int:
    init_logging()  # env_logger parity: RUST_LOG / KTA_LOG
    args = build_parser().parse_args(argv)
    try:
        with telemetry_session(
            metrics_port=args.metrics_port,
            events_jsonl=args.events_jsonl,
            trace_json=args.trace_json,
            flight_record=args.flight_record,
        ):
            return run(args)[0]
    except OSError as e:
        # A bad --trace-json/--events-jsonl path or a busy --metrics-port.
        print(f"error: {e}", file=sys.stderr)
        return 1
