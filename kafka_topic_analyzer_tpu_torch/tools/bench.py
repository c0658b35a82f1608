"""Benchmark: analyzer throughput (msgs/s) of the torch backend on one card
(port of the reference's repo-root ``bench.py``).

    python -m kafka_topic_analyzer_tpu_torch.tools.bench --config 3 --accuracy
    python -m kafka_topic_analyzer_tpu_torch.tools.bench --device cpu ...

Protocol: pre-make synthetic record batches on the host (ingest is
benchmarked separately: the native shim's generator runs at memory
speed), then stream them through `backends.gpu.TorchBackend` (each step
packs its batch on the main thread, copies it to the card and folds it),
and report messages/second over the timed window, which ends in
``torch.cuda.synchronize``.

Output contract: the LAST stdout line is one JSON object,
  {"metric": "msgs_per_sec", "value": N, "unit": "msgs/s",
   "vs_baseline": R, "batch_size": B, "platform": "gpu", "device": ...}
``vs_baseline`` is the ratio to the reference's only published number,
590,221 msgs/s (BASELINE.md).  On the card it adds the breakdown: the
headline-size copy bandwidth from pinned (``transfer_gbps``) and
pageable (``transfer_gbps_pageable``) memory, and the rate of the same
step with its packed rows already on the card
(``device_resident_msgs_per_sec``).  ``--accuracy`` adds the sketch
errors against the numpy exact oracle over the same records, and their
distribution over ``--accuracy-seeds`` more datasets.

The run is on the card unless ``--device cpu`` asks for the host.
Without a card it exits non-zero and prints no result: there is no
fallback to the host and no supervisor that reruns it there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

BASELINE_MSGS_PER_SEC = 590_221.0


#: BASELINE.json benchmark configs (scaled-down record counts; the shape of
#: each workload — partitions, features, key cardinality — is preserved).
CONFIGS = {
    1: dict(partitions=1, features="counters", keys=10_000,
            help="1-partition default metrics scan"),
    2: dict(partitions=16, features="counters,quantiles", keys=200_000,
            help="16-partition size histograms + ts range"),
    3: dict(partitions=16, features="counters,alive,hll", keys=1_000_000,
            help="log-compacted alive/distinct keys"),
    4: dict(partitions=16, features="counters,quantiles", keys=200_000,
            vmin=10, vmax=65_000, help="mixed-size payload percentiles"),
    5: dict(partitions=64, features="counters,alive,hll,quantiles",
            keys=500_000, help="8-topic fan-in shape (64 total rows)"),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=int, choices=sorted(CONFIGS),
                    help="BASELINE.json workload preset (overrides "
                         "--partitions/--features)")
    ap.add_argument("--partitions", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=1 << 20,
                    help="records per device step (default 2^20)")
    ap.add_argument("--batches", type=int, default=8,
                    help="distinct pre-made batches")
    ap.add_argument("--steps", type=int, default=64,
                    help="timed device steps (cycling the batches)")
    ap.add_argument("--features", default="counters,hll,quantiles",
                    help="comma set: counters,alive,hll,quantiles")
    ap.add_argument("--alive-bits", type=int, default=26)
    ap.add_argument("--keys", type=int, default=200_000)
    ap.add_argument("--vmin", type=int, default=100)
    ap.add_argument("--vmax", type=int, default=420)
    ap.add_argument("--pallas", action="store_true",
                    help="the reference's Pallas flag: its v4 checks "
                         "(batch size %% 1024, value lengths); both counter "
                         "folds run the CUDA kernels on a card either way")
    ap.add_argument("--wire-format", choices=["v4", "v5"], default="v5",
                    help="packed wire format: v5 combiner rows (host "
                         "pre-reduced fold tables, counters_merge) or v4 "
                         "per-record columns (counters_update); "
                         "byte-identical results")
    ap.add_argument("--alive-compaction", choices=["auto", "off"],
                    default="auto",
                    help="'auto' ships one bounded per-dispatch pair table "
                         "applied after the fold, 'off' keeps the per-row "
                         "pair sections; byte-identical results")
    ap.add_argument("--superbatch", default="1", metavar="K|auto",
                    help="fold K packed batches per dispatch ('auto' "
                         "targets 2^20 records per dispatch)")
    ap.add_argument("--dispatch-depth", type=int, default=2,
                    help="dispatches allowed in flight while the device "
                         "folds (default 2)")
    ap.add_argument("--accuracy", action="store_true",
                    help="also run the numpy exact oracle over the same "
                         "records and report sketch errors")
    ap.add_argument("--accuracy-seeds", type=int, default=6,
                    help="extra independent dataset seeds for the sketch-"
                         "error distribution (mean/max reported beside the "
                         "main run's draw)")
    ap.add_argument("--accuracy-seed-batches", type=int, default=None,
                    help="batches per accuracy seed (default: --batches, "
                         "so each seed is drawn at the main run's "
                         "cardinality)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the torch backend runs (cuda fails when "
                         "there is no card)")
    return ap


def _source(spec, label: str):
    """The shim's generator when it loads, else numpy's (the same
    records); says which on stderr."""
    from kafka_topic_analyzer_tpu_torch.io import native
    from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource

    if native.native_available():
        return native.NativeSyntheticSource(spec)
    print(f"bench: native shim unavailable ({native.native_status()[1]}); "
          f"{label} records from numpy", file=sys.stderr)
    return SyntheticSource(spec)


def _sketch_errors(sketch, exact, config) -> "tuple[float | None, list | None]":
    """(HLL relative error, each quantile's relative error) of a sketched
    result against the oracle's exact one; None where not measured."""
    hll = None
    if config.enable_hll and exact.distinct_keys_exact:
        hll = (abs(sketch.distinct_keys_hll - exact.distinct_keys_exact)
               / exact.distinct_keys_exact)
    quant = None
    if config.enable_quantiles and exact.quantiles is not None:
        quant = [abs(s - e) / e
                 for s, e in zip(sketch.quantiles.values, exact.quantiles.values)
                 if e]
    return hll, quant


def main(argv: "list[str] | None" = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.accuracy_seed_batches is not None and args.accuracy_seed_batches < 1:
        ap.error("--accuracy-seed-batches must be >= 1")
    if args.config:
        preset = CONFIGS[args.config]
        args.partitions = preset["partitions"]
        args.features = preset["features"]
        args.keys = preset.get("keys", args.keys)
        args.vmin = preset.get("vmin", args.vmin)
        args.vmax = preset.get("vmax", args.vmax)
        print(f"bench: config {args.config} — {preset['help']}", file=sys.stderr)

    import torch

    from kafka_topic_analyzer_tpu_torch._torch_support import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    on_card = dev.type == "cuda"
    platform = "gpu" if on_card else "cpu"
    device_name = torch.cuda.get_device_name(dev) if on_card else "cpu"

    from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
    from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig, DispatchConfig
    from kafka_topic_analyzer_tpu_torch.io import native
    from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSpec
    from kafka_topic_analyzer_tpu_torch.packing import packed_nbytes

    feats = set(args.features.split(","))
    config = AnalyzerConfig(
        num_partitions=args.partitions,
        batch_size=args.batch_size,
        count_alive_keys="alive" in feats,
        alive_bitmap_bits=args.alive_bits,
        enable_hll="hll" in feats,
        enable_quantiles="quantiles" in feats,
        use_pallas_counters=args.pallas,
        wire_format={"v4": 4, "v5": 5}[args.wire_format],
        alive_compaction=args.alive_compaction,
    )
    spec = SyntheticSpec(
        num_partitions=args.partitions,
        messages_per_partition=(args.batch_size * args.batches) // args.partitions,
        keys_per_partition=args.keys,
        key_null_permille=50,
        tombstone_permille=100,
        value_len_min=args.vmin,
        value_len_max=args.vmax,
        seed=0xBEEF,
    )
    use_native = native.native_available()

    print(f"bench: device={dev} ({device_name})", file=sys.stderr)
    t_gen = time.perf_counter()
    src = _source(spec, "bench")
    host_batches = [b.pad_to(args.batch_size) for b in src.batches(args.batch_size)]
    gen_s = time.perf_counter() - t_gen
    total_host = sum(b.num_valid for b in host_batches)
    print(
        f"bench: generated {total_host} records in {gen_s:.1f}s "
        f"({total_host / gen_s:,.0f}/s host, {type(src).__name__}); "
        f"{packed_nbytes(config, args.batch_size) / args.batch_size:.1f} B/record on the wire",
        file=sys.stderr,
    )

    def backend_of(dispatch=None) -> TorchBackend:
        return TorchBackend(config, init_now_s=0, device=dev,
                            use_native=use_native, dispatch=dispatch)

    def wait(backend: TorchBackend) -> None:
        backend.drain_dispatch()
        if on_card:
            torch.cuda.synchronize(dev)

    backend = backend_of(DispatchConfig.parse(args.superbatch, args.dispatch_depth))
    super_k = backend.superbatch_k
    # Warmup: the kernels' first load and the allocator's first touch, one
    # full superbatch, so the timed loop pays neither.  The warmup batches
    # are part of the fold (and of the oracle's identical feed below).
    warmup = [host_batches[i % len(host_batches)] for i in range(super_k)]
    if super_k > 1:
        backend.update_superbatch(warmup)
    else:
        backend.update(warmup[0])
    wait(backend)

    t0 = time.perf_counter()
    if super_k > 1:
        for i in range(0, args.steps, super_k):
            backend.update_superbatch([
                host_batches[j % len(host_batches)]
                for j in range(i, min(i + super_k, args.steps))
            ])
    else:
        for i in range(args.steps):
            backend.update(host_batches[i % len(host_batches)])
    wait(backend)
    dt = time.perf_counter() - t0

    n = args.steps * args.batch_size
    msgs_per_sec = n / dt
    metrics = backend.finalize()
    folded = n + super_k * args.batch_size  # incl. warmup
    if int(metrics.overall_count) != folded:
        raise RuntimeError(
            f"bench: folded {int(metrics.overall_count)} records, expected {folded}"
        )

    print(f"bench: {n} records in {dt:.3f}s on {dev}", file=sys.stderr)
    result = {
        "metric": "msgs_per_sec",
        "value": round(msgs_per_sec, 1),
        "unit": "msgs/s",
        "vs_baseline": round(msgs_per_sec / BASELINE_MSGS_PER_SEC, 2),
        "batch_size": args.batch_size,
        "platform": platform,
        "device": device_name,
    }

    # Measured breakdown: where does the streamed number bind?  (a) the
    # host→device copy, (b) the step rate with the rows already on the
    # card.  On the card only: a host-to-host copy reported as
    # `transfer_gbps` would poison cross-report comparisons.
    if on_card:
        try:
            from kafka_topic_analyzer_tpu_torch.packing import pack_batch
            from kafka_topic_analyzer_tpu_torch.tools.hwmeasure import (
                headline_transfer_gbps,
                timed_step_loop,
            )

            result["transfer_gbps"] = headline_transfer_gbps(dev)
            result["transfer_gbps_pageable"] = headline_transfer_gbps(dev, pinned=False)
            dev_bufs = [
                torch.from_numpy(pack_batch(b, config, use_native=use_native)).to(dev)
                for b in host_batches[: min(2, len(host_batches))]
            ]
            resident = timed_step_loop(
                config, dev_bufs, steps=min(32, args.steps),
                device_resident=True, device=dev,
            )
            result["device_resident_msgs_per_sec"] = resident["msgs_per_sec"]
        except Exception as e:  # the breakdown is informative, never fatal
            result["breakdown_error"] = repr(e)

    if args.accuracy and (config.enable_hll or config.enable_quantiles):
        # Sketch error against the exact oracle, fed EXACTLY the sequence
        # the card folded (warmup batches + steps cycling the batch list),
        # so the comparison measures sketch error, not dataset mismatch.
        from kafka_topic_analyzer_tpu_torch.backends.cpu import CpuExactBackend

        t_acc = time.perf_counter()
        oracle = CpuExactBackend(config, init_now_s=0)
        for b in warmup:
            oracle.update(b)
        for i in range(args.steps):
            oracle.update(host_batches[i % len(host_batches)])
        hll, quant = _sketch_errors(metrics, oracle.finalize(), config)
        if hll is not None:
            result["hll_rel_error"] = round(hll, 5)
        if quant is not None:
            result["quantile_rel_error_max"] = round(max(quant), 5) if quant else 0.0

        # Error DISTRIBUTION over independent seeds: one draw cannot tell a
        # sketch within budget from a lucky one.  Each seed's dataset has
        # the main run's batch count (HLL error depends on cardinality).
        seed_errs_hll: "list[float]" = []
        seed_errs_q: "list[float]" = []
        acc_batches = (args.accuracy_seed_batches
                       if args.accuracy_seed_batches is not None
                       else args.batches)
        if args.accuracy_seeds > 0:
            result["accuracy_seed_batches"] = acc_batches
            result["accuracy_seed_records"] = acc_batches * args.batch_size
        for s in range(max(0, args.accuracy_seeds)):
            sspec = dataclasses.replace(
                spec,
                seed=0xACC0 + s,
                messages_per_partition=(args.batch_size * acc_batches)
                // args.partitions,
            )
            sbatches = [b.pad_to(args.batch_size)
                        for b in _source(sspec, "seed").batches(args.batch_size)]
            sk_backend = backend_of()
            sk_oracle = CpuExactBackend(config, init_now_s=0)
            for b in sbatches:
                sk_backend.update(b)
                sk_oracle.update(b)
            hll, quant = _sketch_errors(sk_backend.finalize(), sk_oracle.finalize(),
                                        config)
            if hll is not None:
                seed_errs_hll.append(hll)
            if quant:
                seed_errs_q.append(max(quant))
        if seed_errs_hll:
            result["hll_rel_error_seeds"] = [round(e, 5) for e in seed_errs_hll]
            result["hll_rel_error_mean"] = round(
                sum(seed_errs_hll) / len(seed_errs_hll), 5
            )
            result["hll_rel_error_max"] = round(max(seed_errs_hll), 5)
        if seed_errs_q:
            result["quantile_rel_error_seeds_max"] = round(max(seed_errs_q), 5)
        print(
            f"bench: accuracy referee took {time.perf_counter() - t_acc:.1f}s "
            f"({len(seed_errs_hll) or len(seed_errs_q)} extra seeds)",
            file=sys.stderr,
        )

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
