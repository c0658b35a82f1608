"""Command line of the port: the synthetic and segment-file batch scans
(port of the reference's ``cli.py``, the flags of the ported scan paths).

    python -m kafka_topic_analyzer_tpu_torch -t T \\
        (--source synthetic --synthetic SPEC | --source segfile \\
         --segment-dir DIR) -c --distinct-keys-per-partition \\
        --quantiles-per-partition --pallas [--batch-size B] \\
        [--alive-bitmap-bits N] [--wire-format auto|v4|v5] \\
        [--alive-compaction auto|off] [--native auto|on|off] \\
        [--backend gpu|cpu]

Prints the same report bytes as the reference CLI for the same inputs
(apart from the two timing lines).  ``--backend gpu`` (the default) runs
on the first CUDA device and fails when there is none; ``--backend cpu``
runs the same code on the host.  ``--native`` chooses the native ingest
shim: ``auto`` (the default) uses it when it builds and falls back to
numpy otherwise, ``on`` raises when it cannot be built, ``off`` runs
numpy only (and so the chained, not the fused, segment-file path).  An
empty topic exits 254, the reference's ``exit(-2)``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

from kafka_topic_analyzer_tpu_torch import __version__
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.io import native
from kafka_topic_analyzer_tpu_torch.io.kafka_codec import KafkaProtocolError
from kafka_topic_analyzer_tpu_torch.io.segfile import SegmentFileSource
from kafka_topic_analyzer_tpu_torch.io.source import RecordSource
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.report import render_report

#: Exit status of a scan of an empty topic (the reference's ``exit(-2)``).
EXIT_EMPTY_TOPIC = 254


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
    p.add_argument("-c", "--count-alive-keys", action="store_true",
                   help="Counts the effective number of alive keys in a log "
                        "compacted topic. A key is 'alive' when it is present "
                        "and has a non-null value in its latest-offset version")
    p.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                   help="Device the scan runs on: the first CUDA device "
                        "(gpu) or the host (cpu). Default: gpu")
    p.add_argument("--source", choices=["synthetic", "segfile"],
                   default="synthetic",
                   help="Record source: a synthetic topic, or .ktaseg "
                        "segment dumps (the Kafka wire source is not yet "
                        "ported)")
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
    p.add_argument("--distinct-keys-per-partition", action="store_true",
                   help="Estimate distinct keys with one HyperLogLog "
                        "register file per partition")
    p.add_argument("--quantiles-per-partition", action="store_true",
                   help="Message-size quantiles with one DDSketch per "
                        "partition")
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


def make_source(args, use_native: bool) -> RecordSource:
    if args.source == "segfile":
        if not args.segment_dir:
            raise SystemExit(
                "--source segfile requires --segment-dir (a local "
                "directory of .ktaseg dumps, or a remote store spec like "
                "http(s)://host:port/bucket or s3://bucket/prefix)"
            )
        return SegmentFileSource(args.segment_dir, topic=args.topic)
    spec = SyntheticSpec.from_kv(parse_kv_pairs(args.synthetic))
    if use_native:
        return native.NativeSyntheticSource(spec)
    return SyntheticSource(spec)


def setup(args) -> "tuple[RecordSource, AnalyzerConfig, bool]":
    """Source, config and the resolved ``--native`` from parsed flags;
    raises ValueError on a bad flag value."""
    use_native = resolve_native(args)
    source = make_source(args, use_native)
    config = AnalyzerConfig(
        num_partitions=len(source.partitions()),
        batch_size=args.batch_size,
        count_alive_keys=args.count_alive_keys,
        alive_bitmap_bits=args.alive_bitmap_bits,
        distinct_keys_per_partition=args.distinct_keys_per_partition,
        quantiles_per_partition=args.quantiles_per_partition,
        use_pallas_counters=args.pallas,
        wire_format=resolve_wire_format(args),
        alive_compaction=args.alive_compaction,
    )
    return source, config, use_native


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        source, config, use_native = setup(args)
    except (ValueError, OSError, KafkaProtocolError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if source.is_empty():
        print(
            "Given topic has no content, no analysis possible. Exiting.",
            file=sys.stderr,
        )
        return EXIT_EMPTY_TOPIC
    backend = TorchBackend(config, device=args.backend, use_native=use_native)
    print(f"Subscribing to {args.topic}")
    print("Starting message consumption...")
    try:
        result = run_scan(args.topic, source, backend, args.batch_size)
    except (OSError, KafkaProtocolError) as e:
        # A damaged dump or an unreadable file: one line, as the
        # reference prints it.
        print(f"error: {e}", file=sys.stderr)
        return 1
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
    return 0
