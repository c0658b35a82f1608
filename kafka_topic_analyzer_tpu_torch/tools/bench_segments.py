"""Cold-path capacity benchmark: broker-bypass segment scanning rec/s vs
worker count, plus the remote-tier latency-hiding referee (port of the
reference's ``tools/bench_segments.py``).

Measures the `--source segfile` ingest pipeline — .ktaseg chunks →
zero-copy column views → wire pack — through the same partition-sharded
fan-in the engine runs (`parallel/ingest.py`), minus the device backend,
so the number is the cold scan's host ingest ceiling.  With ``--store
serve`` the same chunks are served through the in-process S3-shaped
object store (tools/objstore_serve.py) with ``--inject-latency-ms`` of
per-GET service delay, and the sweep crosses worker counts with
``--readahead`` depths — the referee for DESIGN.md §21's claim that
read-ahead hides wire latency behind the decode→pack pass.  ``--cache``
adds the warm-vs-cold re-audit split (pass 1 fills the segment cache,
later passes hit it).

One JSON line, bench_ingest-style: per-cell wall rates (best-of with the
full run list), records/client-CPU-second, and the catalog digest.

Usage:
    python -m kafka_topic_analyzer_tpu_torch.tools.bench_segments \
        --records 8000000 --partitions 16 --workers 1,2,4,8
    python -m kafka_topic_analyzer_tpu_torch.tools.bench_segments \
        --records 2000000 --partitions 16 --workers 4 \
        --store serve --inject-latency-ms 50 --readahead 0,4
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig, SegmentFetchConfig


def _build_segments(args, directory: str) -> None:
    """Synthesize the workload as .ktaseg chunks (tools/make_segments with
    the native generator when available)."""
    from kafka_topic_analyzer_tpu_torch.tools.make_segments import main as ms_main

    per_part = max(args.records // args.partitions, 1)
    spec = (
        f"partitions={args.partitions},messages={per_part},"
        f"keys={args.keys},tombstones=100"
    )
    rc = ms_main([
        "--out", directory, "--topic", args.topic, "--synthetic", spec,
        "--batch-size", str(max(args.batch_size, 1 << 18)),
        "--chunk-records", str(args.chunk_records),
        "--native", args.native,
    ])
    if rc != 0:
        raise SystemExit("segment generation failed")


def _measure(source, batch_size: int, workers: int, stage) -> dict:
    """One timed drain: N=1 is the sequential referee (plain batches()
    loop + inline stage — the engine's prefetch path minus the thread),
    N>1 the deterministic fan-in with per-worker staging, exactly what
    `--ingest-workers N` runs inside the engine."""
    from kafka_topic_analyzer_tpu_torch.parallel.ingest import (
        ParallelIngest,
        shard_partitions,
    )

    got = 0
    c0 = os.times()
    t0 = time.perf_counter()
    if workers == 1:
        for batch in source.batches(batch_size):
            if stage is not None:
                stage(batch)
            got += len(batch)
    else:
        groups = shard_partitions(
            source.partitions(), workers,
            weights=source.partition_record_counts(),
        )
        pool = ParallelIngest(source, batch_size, groups, stage=stage, depth=2)
        try:
            for batch, _staged in pool:
                got += len(batch)
        finally:
            pool.close()
    wall = time.perf_counter() - t0
    c1 = os.times()
    return {
        "records": got,
        "wall": wall,
        "cpu": (c1.user - c0.user) + (c1.system - c0.system),
    }


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--segment-dir",
                    help="existing .ktaseg directory to scan; default: "
                         "synthesize one from the workload flags below "
                         "into a temp dir")
    ap.add_argument("--topic", default="bench-seg")
    ap.add_argument("--records", type=int, default=8_000_000)
    ap.add_argument("--partitions", type=int, default=16)
    ap.add_argument("--keys", type=int, default=5000)
    ap.add_argument("--batch-size", type=int, default=1 << 16)
    ap.add_argument("--chunk-records", type=int, default=1 << 16,
                    help="rolled chunk size for synthesized segments "
                         "(many chunks per partition = the shape "
                         "read-ahead works against)")
    ap.add_argument("--workers", default="1,2,4,8",
                    help="comma-separated worker counts to sweep")
    ap.add_argument("--store", default="dir", metavar="dir|serve|URL",
                    help="'dir' scans the local directory (the round-8 "
                         "referee); 'serve' serves the same chunks "
                         "through the in-process S3-shaped store "
                         "(tools/objstore_serve.py) and scans remotely; "
                         "an http(s):// URL scans that store as-is")
    ap.add_argument("--inject-latency-ms", type=float, default=0.0,
                    help="per-GET service delay for --store serve — the "
                         "wire-RTT stand-in the read-ahead referee "
                         "measures against")
    ap.add_argument("--readahead", default="auto",
                    help="comma-separated --segment-readahead depths to "
                         "sweep for remote stores (e.g. '0,4'); 'auto' "
                         "uses the resolved default")
    ap.add_argument("--fetch-concurrency", default="auto",
                    help="comma-separated --fetch-concurrency sizes to "
                         "sweep for remote stores (e.g. '2,4,8'), 'auto' "
                         "for the resolved default only, or 'sweep' for "
                         "the canonical 2,4,8,auto ladder — the "
                         "referee for the shared-scheduler admission "
                         "layer")
    ap.add_argument("--cache", metavar="DIR",
                    help="run remote cells through a --segment-cache at "
                         "DIR: the first pass per cell is recorded as "
                         "COLD (cache cleared), later passes as WARM")
    ap.add_argument("--timeout-s", type=float, default=30.0,
                    help="remote fetch timeout per request")
    ap.add_argument("--repeat", type=int, default=3,
                    help="passes per cell; best is the headline "
                         "(capacity is a max on a shared box), with the "
                         "full run list alongside")
    ap.add_argument("--no-pack", action="store_true",
                    help="skip the wire pack stage (isolates the "
                         "read cost; default stages pack on the "
                         "workers exactly like the torch cold scan)")
    ap.add_argument("--features", default="counters",
                    help="comma list for the pack config: counters[,alive]"
                         "[,hll][,quantiles]")
    ap.add_argument("--native", choices=["auto", "on", "off"], default="auto")
    args = ap.parse_args(argv)
    sweep = [int(w) for w in args.workers.split(",") if w]
    if any(w < 1 for w in sweep):
        ap.error("--workers entries must be >= 1")
    if args.cache and args.store == "dir":
        ap.error("--cache only applies to remote stores (--store serve/URL)")
    if args.cache and args.repeat < 2:
        ap.error(
            "--cache needs --repeat >= 2: pass 1 is the COLD fill; "
            "reporting it as the warm headline would compare cold to cold"
        )
    ra_sweep: "list[int | str]" = [
        ("auto" if r.strip().lower() == "auto" else int(r))
        for r in args.readahead.split(",")
        if r.strip()
    ]
    fc_text = args.fetch_concurrency.strip().lower()
    if fc_text == "sweep":
        fc_text = "2,4,8,auto"
    fc_sweep: "list[int | str]" = [
        ("auto" if c.strip().lower() == "auto" else int(c))
        for c in fc_text.split(",")
        if c.strip()
    ]
    if any(isinstance(c, int) and c < 1 for c in fc_sweep):
        ap.error("--fetch-concurrency entries must be >= 1 or 'auto'")

    from kafka_topic_analyzer_tpu_torch.io.segfile import SegmentFileSource
    from kafka_topic_analyzer_tpu_torch.packing import pack_batch

    tmp = None
    seg_dir = args.segment_dir
    if seg_dir is None:
        tmp = tempfile.mkdtemp(prefix="kta-bench-seg-")
        seg_dir = tmp
        print(f"bench_segments: building segments in {seg_dir}",
              file=sys.stderr)
        _build_segments(args, seg_dir)
    server = None
    store_spec = None
    if args.store == "serve":
        from kafka_topic_analyzer_tpu_torch.tools.objstore_serve import (
            ObjectStoreHttpServer,
        )

        server = ObjectStoreHttpServer(
            seg_dir, latency_ms=args.inject_latency_ms
        ).start()
        store_spec = server.url
        print(f"bench_segments: serving {seg_dir} at {store_spec} "
              f"(+{args.inject_latency_ms:g} ms/GET)", file=sys.stderr)
    elif args.store != "dir":
        store_spec = args.store
    remote = store_spec is not None
    if not remote:
        ra_sweep = ["auto"]  # local: readahead resolves to 0; one cell
        fc_sweep = ["auto"]  # local scans never touch the scheduler

    def make_source(ra, fc="auto") -> SegmentFileSource:
        if not remote:
            return SegmentFileSource(seg_dir, args.topic)
        fetch = SegmentFetchConfig(
            readahead=ra,
            cache_dir=args.cache,
            timeout_s=args.timeout_s,
            fetch_concurrency=fc,
        )
        return SegmentFileSource(store_spec, args.topic, fetch=fetch)

    def reset_scheduler() -> None:
        """Fresh scheduler per fetch-concurrency cell: the pool is a
        process singleton and an explicit size latches, so sweeping
        sizes inside one bench process needs a clean teardown between
        cells (threads joined, configuration forgotten)."""
        if remote:
            from kafka_topic_analyzer_tpu_torch.io import fetchsched

            fetchsched._reset_for_tests()

    try:
        probe = make_source(0 if remote else "auto")
        feats = {f.strip() for f in args.features.split(",") if f.strip()}
        config = AnalyzerConfig(
            num_partitions=len(probe.partitions()),
            batch_size=args.batch_size,
            count_alive_keys="alive" in feats,
            enable_hll="hll" in feats,
            enable_quantiles="quantiles" in feats,
        )
        use_native = args.native in ("auto", "on")
        stage = None
        if not args.no_pack:
            # Mirror the engine's worker staging: dense ids + wire pack
            # (native, GIL-released) on the worker thread.  Synthetic dumps
            # are dense already; a user-supplied catalog may not be.
            from kafka_topic_analyzer_tpu_torch.engine import PartitionIndex

            pindex = PartitionIndex(probe.partitions())

            def stage(b):  # noqa: F811 — the staging callable
                return pack_batch(
                    pindex.dense_batch(b), config, use_native=use_native
                )

        doc: "dict[str, object]" = {
            "metric": "segments",
            "nproc": os.cpu_count(),
            "topic": args.topic,
            "batch_size": args.batch_size,
            "pack": not args.no_pack,
            "features": sorted(feats),
            "store": args.store,
            "inject_latency_ms": args.inject_latency_ms,
            "cache": bool(args.cache),
            "fetch_concurrency": [str(c) for c in fc_sweep],
            "catalog": {
                "files": probe.catalog.num_files,
                "bytes": probe.catalog.total_bytes,
                "records": sum(probe.catalog.record_counts().values()),
                "partitions": len(probe.partitions()),
            },
        }
        rates: "dict[str, int]" = {}
        runs: "dict[str, list[int]]" = {}
        cpu_rates: "dict[str, int]" = {}
        cold_rates: "dict[str, int]" = {}
        for n in sweep:
            for ra in ra_sweep:
              for fc in fc_sweep:
                if not remote:
                    key = str(n)
                elif len(fc_sweep) > 1:
                    key = f"w{n}.ra{ra}.fc{fc}"
                else:
                    # Round-14-compatible keys when concurrency isn't
                    # being swept, so old/new ledgers diff cell-by-cell.
                    key = f"w{n}.ra{ra}"
                reset_scheduler()
                if args.cache:
                    # Cold half of the warm-vs-cold referee: an empty
                    # cache, so pass 1 pays every fetch.
                    shutil.rmtree(args.cache, ignore_errors=True)
                best = None
                n_runs = []
                for rep in range(max(args.repeat, 1)):
                    # A fresh source per pass: per-file constant caches and
                    # OS page cache persist (deliberately — cold *IO* is
                    # the disk's story; this measures the pipeline), but
                    # reader state does not leak across cells.  The warm
                    # passes also restart the verify latch trust (new
                    # scheduler/config process state persists within a
                    # bench process — the latch is per-process, so pass 2+
                    # measure the LATCHED warm path).
                    src = make_source(ra, fc)
                    r = _measure(src, args.batch_size, n, stage)
                    rate = round(r["records"] / r["wall"])
                    n_runs.append(rate)
                    if args.cache and rep == 0:
                        cold_rates[key] = rate
                    if best is None or r["records"] / r["wall"] > (
                        best["records"] / best["wall"]
                    ):
                        best = r
                warm_runs = n_runs[1:] if args.cache and len(n_runs) > 1 \
                    else n_runs
                rates[key] = max(warm_runs)
                runs[key] = n_runs
                cpu_rates[key] = (
                    round(best["records"] / best["cpu"]) if best["cpu"] else 0
                )
                print(
                    f"bench_segments: {key}: {best['records']} records, "
                    f"best of {len(n_runs)}: {rates[key]:,}/s "
                    f"(wall={best['wall']:.2f}s cpu={best['cpu']:.2f}s)"
                    + (
                        f" cold={cold_rates[key]:,}/s"
                        if key in cold_rates else ""
                    ),
                    file=sys.stderr,
                )
        doc["seg_msgs_per_sec"] = rates
        doc["seg_runs"] = runs
        doc["seg_cpu_msgs_per_sec"] = cpu_rates
        if cold_rates:
            doc["seg_cold_msgs_per_sec"] = cold_rates
        if "1" in rates:
            doc["speedup_vs_1"] = {
                n: round(v / rates["1"], 2) for n, v in rates.items()
            }
        print(json.dumps(doc))
        return 0
    finally:
        if server is not None:
            server.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
