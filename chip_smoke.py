#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure exits non-zero:

- build: compiles every CUDA kernel of the port from the sources in this
  checkout (one ``nvcc`` per source) and prints the build time and the
  compiler's register report;
- kernel: ``counters_merge`` on CUDA against its plain PyTorch version at
  P in {1, 16, 300, 32767}, with 2^32 carries, values at I64_MAX and
  zeros, exact equality; then its time at the scan's shape (P = 16)
  beside the plain version, one ``torch.add`` (a yardstick the port never
  calls) and the bound;
- identity: the port's CLI at partitions=4, messages=200000, keys=50000
  with the 2^32-slot alive bitmap, once on ``cuda`` and once on ``cpu``:
  the reports must be byte-identical apart from the two timing lines;
- scan: the full-size v5 scan (partitions=16, messages=1000000,
  keys=3000000: 16M records, 512 MiB alive bitmap, per-partition HLL and
  quantiles) on ``cuda`` through the CLI's own setup, engine and backend.
  The kernel's launch counter is zeroed just before and read just after:
  it must equal the number of dispatches.

Prints the card's name and power limit (``nvidia-smi``), a ``kernels``
JSON line, and as its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
import time

#: Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the
#: non-tensor-core fp32 rate as the rate of a CUDA-core integer add.
PEAK_BYTES_PER_S = 3.35e12
PEAK_SIMT_OPS_PER_S = 67e12

FULL_SPEC = "partitions=16,messages=1000000,keys=3000000"
IDENTITY_SPEC = "partitions=4,messages=200000,keys=50000"
SKETCH_FLAGS = [
    "-c", "--distinct-keys-per-partition", "--quantiles-per-partition",
    "--pallas", "--alive-bitmap-bits", "32",
]


def fail(msg: str) -> "None":
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 20) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around
    ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def merge_tables(p: int, rng):
    """Counter tables with the cases the TPU kernel's carry logic had to
    get right: 2^32 carries, values at I64_MAX (the add wraps), zeros."""
    import numpy as np

    i64_max = np.iinfo(np.int64).max
    a = rng.integers(-(1 << 62), 1 << 62, size=(p, 7), dtype=np.int64)
    d = rng.integers(0, 1 << 40, size=(p, 7), dtype=np.int64)
    a[:, 0], d[:, 0] = 0xFFFFFFFF, rng.integers(1, 1 << 33, size=p)
    a[:, 1], d[:, 1] = i64_max - 3, 3
    a[:, 2], d[:, 2] = i64_max, 1
    a[:, 3], d[:, 3] = 0, 0
    return a, d


def phase_kernel(torch, np, counters_merge, counters_merge_plain) -> dict:
    rng = np.random.default_rng(20261016)
    worst = 0
    for p in (1, 16, 300, 32767):
        a, d = merge_tables(p, rng)
        acc = torch.from_numpy(a).cuda()
        delta = torch.from_numpy(d).cuda()
        want = counters_merge_plain(acc, delta)
        got = counters_merge(acc.clone(), delta)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        print(f"kernel: counters_merge P={p}: max_abs_err={err}")
        if not torch.equal(got, want):
            fail(f"counters_merge disagrees with its plain version at P={p}")
        worst = max(worst, err)

    p = 16  # the scan phase's shape
    a, d = merge_tables(p, rng)
    acc = torch.from_numpy(a).cuda()
    delta = torch.from_numpy(d).cuda()
    out = torch.empty_like(acc)
    iters = 2000
    ms = cuda_ms(lambda: counters_merge(acc, delta), iters)
    plain_ms = cuda_ms(lambda: counters_merge_plain(acc, delta), iters)
    library_ms = cuda_ms(lambda: torch.add(acc, delta, out=out), iters)
    nbytes = 3 * 8 * 7 * p
    ops = 7 * p
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_SIMT_OPS_PER_S * 1e3
    row = {
        "name": "counters_merge",
        "route": "cuda",
        "source": "kafka_topic_analyzer_tpu_torch/csrc/counters_merge.cu",
        "replaces": "kafka_topic_analyzer_tpu/ops/pallas_counters.py:216",
        "launches": 0,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }
    print(
        f"kernel: counters_merge P={p}: {ms:.6f} ms, plain {plain_ms:.6f} ms, "
        f"torch.add {library_ms:.6f} ms, bound {row['bound_ms']:.9f} ms "
        f"({nbytes} B)"
    )
    return row


def run_cli(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        fail(f"CLI {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def drop_timing(text: str) -> str:
    return "".join(
        line for line in text.splitlines(keepends=True)
        if not line.startswith(("Scanning took:", "Estimated Msg/s:"))
    )


def phase_identity(torch, main, counters_merge) -> None:
    argv = ["-t", "smoke", "--source", "synthetic", "--synthetic",
            IDENTITY_SPEC, *SKETCH_FLAGS]
    counters_merge.launches = 0
    t0 = time.perf_counter()
    gpu = run_cli(main, argv + ["--backend", "gpu"])
    gpu_s = time.perf_counter() - t0
    launches = counters_merge.launches
    t0 = time.perf_counter()
    cpu = run_cli(main, argv + ["--backend", "cpu"])
    cpu_s = time.perf_counter() - t0
    print(f"identity: gpu {gpu_s:.3f} s ({launches} kernel launches), "
          f"cpu {cpu_s:.3f} s")
    if launches == 0:
        fail("identity: the gpu run launched no counters_merge kernel")
    if drop_timing(gpu) != drop_timing(cpu):
        fail("identity: cuda and cpu reports differ:\n" + gpu + "\n" + cpu)
    print("identity: cuda and cpu reports byte-identical (timing lines aside)")


def phase_scan(torch, np, cli, counters_merge) -> int:
    from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
    from kafka_topic_analyzer_tpu_torch.engine import run_scan
    from kafka_topic_analyzer_tpu_torch.report import render_report

    argv = ["-t", "scan", "--source", "synthetic", "--synthetic", FULL_SPEC,
            *SKETCH_FLAGS, "--backend", "gpu"]
    args = cli.build_parser().parse_args(argv)
    source, config = cli.setup(args)
    backend = TorchBackend(config, device=args.backend)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters_merge.launches = 0
    t0 = time.perf_counter()
    result = run_scan(args.topic, source, backend, args.batch_size)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters_merge.launches
    m = result.metrics
    records = source.total_records()
    words = backend.state.alive.words
    dispatches = math.ceil(records / config.batch_size)
    print(f"scan: {records} records in {wall:.3f} s = {records / wall:.1f} "
          f"records/s; {backend.dispatches} dispatches, {launches} kernel "
          f"launches; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B")
    sys.stdout.write(render_report(
        args.topic, m, result.start_offsets, result.end_offsets,
        result.duration_secs, show_alive_keys=True,
    ))
    if m.overall_count != 16_000_000 or records != 16_000_000:
        fail(f"scan: overall_count {m.overall_count} != 16000000")
    if any(m.total(p) != 1_000_000 for p in m.partitions):
        fail("scan: a partition total is not 1000000")
    if words.device.type != "cuda" or words.numel() != 1 << 27:
        fail(f"scan: alive bitmap is {words.numel()} words on {words.device}")
    if not (launches > 0 and launches == backend.dispatches == dispatches):
        fail(f"scan: {launches} launches for {backend.dispatches} dispatches "
             f"(expected {dispatches})")
    hll = m.distinct_keys_hll_per_partition
    if not (m.alive_keys and all(math.isfinite(h) and h > 0 for h in hll)):
        fail("scan: alive keys or HLL estimates missing")
    if int(np.sum(m.per_partition[:, 2])) < m.alive_keys:
        fail("scan: more alive keys than alive records")
    breakdown(torch, source, config, wall, backend.dispatches)
    return launches


def breakdown(torch, source, config, wall: float, dispatches: int) -> None:
    """Per-dispatch cost of each stage of the scan, over the scan's first
    batches: synthesis and packing on the host clock (mean of 4), the
    host→device copy and the device fold with CUDA events (on a second
    backend, so the scan's state is untouched)."""
    from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend

    backend = TorchBackend(config, device="gpu")
    batches = source.batches(config.batch_size)
    synth_s = prepare_s = 0.0
    for _ in range(4):
        t0 = time.perf_counter()
        batch = next(batches)
        t1 = time.perf_counter()
        staged = backend.prepare(batch)
        t2 = time.perf_counter()
        synth_s += t1 - t0
        prepare_s += t2 - t1
    synth_ms, prepare_ms = synth_s * 1e3 / 4, prepare_s * 1e3 / 4
    torch.cuda.synchronize()
    host = backend._ring[0]
    dev = torch.empty_like(host, device="cuda")
    copy_ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True), 20, 2)
    fold_ms = cuda_ms(lambda: backend.update(staged), 20, 2)
    per_dispatch_ms = wall * 1e3 / dispatches
    print(
        f"breakdown: per dispatch of {config.batch_size} records: wall "
        f"{per_dispatch_ms:.3f} ms; host synth {synth_ms:.3f} ms, host pack "
        f"{prepare_ms:.3f} ms; device copy {copy_ms:.3f} ms "
        f"({host.numel()} B), device fold {fold_ms:.3f} ms; device busy "
        f"share ~{(copy_ms + fold_ms) / per_dispatch_ms:.4f}"
    )


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"cannot import torch/numpy: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    try:
        from kafka_topic_analyzer_tpu_torch import _build, cli
        from kafka_topic_analyzer_tpu_torch.ops import counters_merge as cm
    except ImportError as e:
        fail(f"the port package is not importable here: {e}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} numpy "
          f"{np.__version__} python {sys.version.split()[0]}; device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    logs = {name: _build.build(name) for name in _build.KERNEL_SOURCES}
    print(f"build: {time.perf_counter() - t0:.3f} s for {len(logs)} kernel(s)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")

    row = phase_kernel(torch, np, cm.counters_merge, cm.counters_merge_plain)
    phase_identity(torch, cli.main, cm.counters_merge)
    row["launches"] = phase_scan(torch, np, cli, cm.counters_merge)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
