"""One-process measurement campaign on one card (port of the reference's
``tools/bench_hw.py``).

Every hardware number the benchmark tools need is measured by THIS single
process, stage by stage, each stage printing a flushed line before moving
on: a stage that fails or hangs is the last one named, and the JSON at
the end (and ``--json PATH``, rewritten after every stage) carries
whatever completed.

Stages:
  init            the device, its name
  build           build and load both CUDA kernels (counters_merge,
                  counters_update) from the sources in the package
  transfer        host->device bandwidth, one copy per size (1/8/32 MiB),
                  from pinned and from pageable memory
  transfer-conc   4 concurrent 8 MiB copies from pinned memory, one CUDA
                  stream each
  pack            host pack throughput (no device)
  stream          full-feature analyzer step, pinned host rows copied to
                  the card each step
  resident        same step with the packed rows already on the card:
                  the card's own rate
  counters        resident, counters-only config in wire v5 (the
                  reference's exact workload; counters_merge)
  pallas          resident, the same records in wire v4 with the
                  reference's --pallas (counters_update); reported beside
                  counters as ``v4_vs_v5``
  big             the stream protocol again at --big-pow (default 2^20)

The reference compares its Pallas kernel with XLA's scatter here
(``pallas_vs_scatter``); on the card both counter folds always run the
hand-written kernels, so the port compares the two wire formats instead.

With ``--device cpu`` the stages that need a card (build, transfer,
transfer-conc) are skipped with a stderr line; the step stages run the
plain versions of the kernels on the host.

Usage: python -m kafka_topic_analyzer_tpu_torch.tools.bench_hw
         [--batch-pow 16] [--steps 64] [--stop-after STAGE] [--json PATH]
         [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _stage(name):
    print(f"bench_hw: [{name}] start", file=sys.stderr, flush=True)
    t0 = time.perf_counter()

    def done(extra: str = ""):
        dt = time.perf_counter() - t0
        print(
            f"bench_hw: [{name}] ok in {dt:.2f}s {extra}",
            file=sys.stderr, flush=True,
        )
        return dt

    return done


def _skip(name: str, why: str) -> None:
    print(f"bench_hw: [{name}] skipped: {why}", file=sys.stderr, flush=True)


STAGES = ["init", "build", "transfer", "transfer-conc", "pack", "stream",
          "resident", "counters", "pallas"]


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-pow", type=int, default=16,
                    help="log2 batch size (16 -> 65536)")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--partitions", type=int, default=16)
    ap.add_argument("--stop-after", default=None, choices=STAGES)
    ap.add_argument("--big-pow", type=int, default=20,
                    help="log2 batch size for the final 'big' stage; "
                         "0 disables it")
    ap.add_argument("--big-steps", type=int, default=8)
    ap.add_argument("--json", default=None, help="also write results here")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the steps run (cuda fails without a card)")
    args = ap.parse_args(argv)
    B = 1 << args.batch_pow
    S = args.steps
    results: dict = {}

    def flush_json() -> None:
        # Incremental: a later stage's failure must not lose earlier numbers.
        if args.json:
            with open(args.json, "w") as f:
                json.dump(results, f, indent=1)

    def emit() -> int:
        print(json.dumps(results), flush=True)
        flush_json()
        return 0

    def stop(stage: str) -> bool:
        return args.stop_after == stage

    # -- init ---------------------------------------------------------------
    done = _stage("init")
    import torch

    from kafka_topic_analyzer_tpu_torch._torch_support import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.init()
    results["device"] = torch.cuda.get_device_name(dev) if on_card else "cpu"
    results["platform"] = "gpu" if on_card else "cpu"
    done(f"{dev} {results['device']}")
    if stop("init"):
        return emit()

    # -- build: both kernels, built from source and loaded ------------------
    if on_card:
        from kafka_topic_analyzer_tpu_torch import _build

        results["build_s"] = {}
        for name in _build.KERNEL_SOURCES:
            done = _stage(f"build {name}")
            _build.load(name)
            results["build_s"][name] = round(done(), 3)
        flush_json()
    else:
        _skip("build", "no card: the steps run the kernels' plain versions")
    if stop("build"):
        return emit()

    from kafka_topic_analyzer_tpu_torch.tools.hwmeasure import (
        HEADLINE_TRANSFER_MIB,
        measure_transfer_gbps,
        timed_step_loop,
    )

    # -- transfer bandwidth -------------------------------------------------
    if on_card:
        done = _stage("transfer")
        sizes = (1, HEADLINE_TRANSFER_MIB, 32)
        pinned = measure_transfer_gbps(dev, sizes, pinned=True)
        pageable = measure_transfer_gbps(dev, sizes, pinned=False)
        # Same keys, same policy as tools/bench.py's line (hwmeasure): the
        # headline-size single copy; the per-size detail keeps its own key.
        results["transfer_gbps"] = pinned[HEADLINE_TRANSFER_MIB]
        results["transfer_gbps_by_mib"] = pinned
        results["transfer_gbps_pageable"] = pageable[HEADLINE_TRANSFER_MIB]
        results["transfer_gbps_pageable_by_mib"] = pageable
        flush_json()
        done("pinned " + " ".join(f"{m}MiB={v:.3f}GB/s" for m, v in pinned.items())
             + "; pageable " + " ".join(f"{m}MiB={v:.3f}GB/s"
                                        for m, v in pageable.items()))
    else:
        _skip("transfer", "no card: a host-to-host copy is no transfer")
    if stop("transfer"):
        return emit()

    if on_card:
        done = _stage("transfer-conc")
        hosts = [torch.full((8 << 20,), i, dtype=torch.uint8, pin_memory=True)
                 for i in range(4)]
        dsts = [torch.empty_like(h, device=dev) for h in hosts]
        streams = [torch.cuda.Stream(dev) for _ in hosts]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for d, h, s in zip(dsts, hosts, streams):
            with torch.cuda.stream(s):
                d.copy_(h, non_blocking=True)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        results["transfer_gbps_concurrent"] = round(4 * 8 / 1024 / dt, 4)
        flush_json()
        done(f"4x8MiB={results['transfer_gbps_concurrent']:.3f}GB/s")
        del dsts, hosts
    else:
        _skip("transfer-conc", "no card")
    if stop("transfer-conc"):
        return emit()

    # -- shared workload ----------------------------------------------------
    from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
    from kafka_topic_analyzer_tpu_torch.io import native
    from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
    from kafka_topic_analyzer_tpu_torch.packing import pack_batch

    use_native = native.native_available()
    full_cfg = AnalyzerConfig(
        num_partitions=args.partitions, batch_size=B,
        count_alive_keys=True, alive_bitmap_bits=26,
        enable_hll=True, enable_quantiles=True,
    )
    cnt_cfg = AnalyzerConfig(num_partitions=args.partitions, batch_size=B)
    v4_cfg = AnalyzerConfig(
        num_partitions=args.partitions, batch_size=B, use_pallas_counters=True,
        wire_format=4,
    )

    def make_batches(batch: int, n: int):
        spec = SyntheticSpec(
            num_partitions=args.partitions,
            messages_per_partition=(n * batch) // args.partitions,
            keys_per_partition=200_000,
            key_null_permille=50,
            tombstone_permille=100,
            seed=0xBEEF,
        )
        src = native.NativeSyntheticSource(spec) if use_native else SyntheticSource(spec)
        return [b.pad_to(batch) for b in src.batches(batch)]

    def host_rows(bufs):
        """Packed rows as the backend stages them: pinned on a card."""
        rows = [torch.from_numpy(b) for b in bufs]
        return [r.pin_memory() for r in rows] if on_card else rows

    done = _stage("pack")
    batches = make_batches(B, 4)
    t0 = time.perf_counter()
    bufs = {}
    for name, cfg in (("full", full_cfg), ("cnt", cnt_cfg)):
        bufs[name] = [pack_batch(b, cfg, use_native=use_native) for b in batches]
    pack_dt = time.perf_counter() - t0
    n_packed = 2 * len(batches) * B
    results["host_pack_msgs_per_sec"] = round(n_packed / pack_dt, 1)
    results["packed_bytes_per_record"] = round(bufs["full"][0].nbytes / B, 1)
    bufs["v4"] = [pack_batch(b, v4_cfg, use_native=use_native) for b in batches]
    flush_json()
    done(f"{n_packed / pack_dt / 1e6:.1f}M rec/s, "
         f"{results['packed_bytes_per_record']}B/rec full")
    if stop("pack"):
        return emit()

    def timed_loop(name, cfg, feed, resident: bool, steps=S):
        """One `hwmeasure.timed_step_loop` recorded under ``name``: host
        rows copied each step, or rows already on the device."""
        done = _stage(name)
        r = timed_step_loop(cfg, feed, steps=steps, device_resident=resident,
                            device=dev)
        results[name + "_msgs_per_sec"] = r["msgs_per_sec"]
        results[name + "_compile_s"] = r["compile_s"]
        flush_json()
        done(f"{r['msgs_per_sec'] / 1e6:.2f}M msgs/s "
             f"(first step {r['compile_s']:.1f}s)")

    def staged(name: str, rows):
        done = _stage(f"stage-{name}-bufs")
        out = [torch.from_numpy(b).to(dev) for b in rows]
        if on_card:
            torch.cuda.synchronize(dev)
        done(f"{len(out)} bufs")
        return out

    # -- stream: host rows cross to the card every step ----------------------
    timed_loop("stream", full_cfg, host_rows(bufs["full"]), resident=False)
    if stop("stream"):
        return emit()

    # -- resident: rows already on the card ----------------------------------
    timed_loop("resident", full_cfg, staged("full", bufs["full"]), resident=True)
    if stop("resident"):
        return emit()

    timed_loop("counters", cnt_cfg, staged("cnt", bufs["cnt"]), resident=True)
    if stop("counters"):
        return emit()

    timed_loop("pallas", v4_cfg, staged("v4", bufs["v4"]), resident=True)
    if results.get("pallas_msgs_per_sec") and results.get("counters_msgs_per_sec"):
        results["v4_vs_v5"] = round(
            results["pallas_msgs_per_sec"] / results["counters_msgs_per_sec"], 3
        )
        flush_json()
    if stop("pallas") or not args.big_pow:
        return emit()

    # -- big: the stream protocol at the bench's batch size -------------------
    BIG = 1 << args.big_pow
    big_cfg = AnalyzerConfig(
        num_partitions=args.partitions, batch_size=BIG,
        count_alive_keys=True, alive_bitmap_bits=26,
        enable_hll=True, enable_quantiles=True,
    )
    done = _stage("big-pack")
    big_bufs = [pack_batch(b, big_cfg, use_native=use_native)
                for b in make_batches(BIG, 2)]
    done(f"{len(big_bufs)} bufs of {big_bufs[0].nbytes >> 20}MiB")
    timed_loop("big", big_cfg, host_rows(big_bufs), resident=False,
               steps=args.big_steps)
    return emit()


if __name__ == "__main__":
    sys.exit(main())
