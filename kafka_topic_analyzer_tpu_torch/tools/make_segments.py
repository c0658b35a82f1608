"""Write .ktaseg segment dumps of a synthetic topic (port of the
reference's ``tools/make_segments.py``).

    python -m kafka_topic_analyzer_tpu_torch.tools.make_segments \\
        --out DIR --topic demo \\
        --synthetic "partitions=4,messages=100000,keys=5000" \\
        [--chunk-records N] [--native auto|on|off]

One file per partition, or with ``--chunk-records N`` rolled
``{topic}-{p}.cK.ktaseg`` chunks of N records each (the shape the remote
tier's read-ahead works against).

The records are the synthetic source's for the spec, generated by the
native shim where it loads (``--native auto``), so a segment-file scan of
the dump gives the same report as the synthetic scan of the spec.
"""

from __future__ import annotations

import argparse
import os
import sys

from kafka_topic_analyzer_tpu_torch.cli import parse_kv_pairs
from kafka_topic_analyzer_tpu_torch.io import native
from kafka_topic_analyzer_tpu_torch.io.segfile import (
    SegmentDumpWriter,
    write_segment_from_batches,
)
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec


def make_segments(out: str, topic: str, spec: SyntheticSpec,
                  batch_size: int = 1 << 20, use_native: bool = False,
                  chunk_records: int = 0) -> "list[str]":
    """Write one ``{topic}-{p}.ktaseg`` per partition of ``spec`` into
    ``out`` (or rolled chunks of ``chunk_records`` records); returns the
    paths."""
    src = native.NativeSyntheticSource(spec) if use_native else SyntheticSource(spec)
    os.makedirs(out, exist_ok=True)
    if chunk_records > 0:
        writer = SegmentDumpWriter(out, topic, records_per_chunk=chunk_records)
        # Batches of the chunk size, so rolling (batch-granular) lands
        # chunks of exactly the requested record count.
        for p in src.partitions():
            for b in src.batches(min(batch_size, chunk_records), partitions=[p]):
                writer.append(b)
        writer.close()
        return sorted(
            os.path.join(out, f) for f in os.listdir(out)
            if f.startswith(f"{topic}-") and f.endswith(".ktaseg")
        )
    return [
        write_segment_from_batches(
            out, topic, p, list(src.batches(batch_size, partitions=[p]))
        )
        for p in src.partitions()
    ]


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="make_segments",
        epilog="--synthetic takes the analyzer CLI's comma-separated k=v "
               "spec; valid keys: " + ", ".join(sorted(SyntheticSpec.KV_KEYS)),
    )
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--topic", required=True)
    ap.add_argument("--synthetic",
                    help="workload spec, comma separated k=v (same format as "
                         "the analyzer CLI), e.g. "
                         "\"partitions=4,messages=100000,keys=5000\"")
    ap.add_argument("--batch-size", type=int, default=1 << 20)
    ap.add_argument("--chunk-records", type=int, default=0,
                    help="roll output into {topic}-{p}.cN.ktaseg chunks of "
                         "this many records (0 = one chunk per partition)")
    ap.add_argument("--native", choices=["auto", "on", "off"], default="auto")
    args = ap.parse_args(argv)
    try:
        spec = SyntheticSpec.from_kv(parse_kv_pairs(args.synthetic))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.native == "on":
        native.load_library()
    use_native = args.native != "off" and native.native_available()
    for path in make_segments(args.out, args.topic, spec, args.batch_size,
                              use_native, args.chunk_records):
        print(f"wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
