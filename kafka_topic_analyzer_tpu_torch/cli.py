"""Command line of the port: the synthetic batch scan (port of the
reference's ``cli.py``, the flags of the v5 scan path).

    python -m kafka_topic_analyzer_tpu_torch -t T --source synthetic \\
        --synthetic SPEC -c --distinct-keys-per-partition \\
        --quantiles-per-partition --pallas [--batch-size B] \\
        [--alive-bitmap-bits N] [--backend gpu|cpu]

Prints the same report bytes as the reference CLI for the same inputs
(apart from the two timing lines).  ``--backend gpu`` (the default) runs
on the first CUDA device and fails when there is none; ``--backend cpu``
runs the same code on the host.  An empty topic exits 254, the
reference's ``exit(-2)``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

from kafka_topic_analyzer_tpu_torch import __version__
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.engine import run_scan
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
    p.add_argument("--source", choices=["synthetic"], default="synthetic",
                   help="Record source (only 'synthetic' is ported)")
    p.add_argument("--synthetic", metavar="SPEC",
                   help="Synthetic workload spec, comma separated k=v: "
                        "partitions,messages,keys,key_null,tombstones,vmin,"
                        "vmax,seed")
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
                   help="Accepted for parity with the reference; the port's "
                        "counter merge always runs its CUDA kernel on a GPU")
    return p


def setup(args) -> "tuple[SyntheticSource, AnalyzerConfig]":
    """Source and config from parsed flags; raises ValueError on a bad
    flag value."""
    source = SyntheticSource(SyntheticSpec.from_kv(parse_kv_pairs(args.synthetic)))
    config = AnalyzerConfig(
        num_partitions=len(source.partitions()),
        batch_size=args.batch_size,
        count_alive_keys=args.count_alive_keys,
        alive_bitmap_bits=args.alive_bitmap_bits,
        distinct_keys_per_partition=args.distinct_keys_per_partition,
        quantiles_per_partition=args.quantiles_per_partition,
        use_pallas_counters=args.pallas,
    )
    return source, config


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        source, config = setup(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if source.is_empty():
        print(
            "Given topic has no content, no analysis possible. Exiting.",
            file=sys.stderr,
        )
        return EXIT_EMPTY_TOPIC
    backend = TorchBackend(config, device=args.backend)
    print(f"Subscribing to {args.topic}")
    print("Starting message consumption...")
    result = run_scan(args.topic, source, backend, args.batch_size)
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
