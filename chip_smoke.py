#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # all phases, one card

Phases, in order; any failure exits non-zero:

- build: compiles every CUDA kernel of the port from the sources in this
  checkout (one ``nvcc`` per source, all started together) and prints the
  build time and the compiler's register report;
- kernel: ``counters_merge`` on CUDA against its plain PyTorch version at
  P in {1, 16, 300, 32767}, with 2^32 carries, values at I64_MAX and
  zeros, and its global sums (``overall_size``/``overall_count``) started
  near I64_MAX so they wrap, exact equality.  Then ``counters_update``
  against its plain version, sums included, at B = 2^18 with lengths up
  to 2^24 - 1, at P in {1, 16, 300, 877, 4096, 32767} (its shared-memory
  and its global-atomic paths), in three record orders: random partitions
  with a 10% invalid tail, the scan's round-robin order, and runs of one
  partition (what a Kafka fetch delivers); exact equality.  Then each
  kernel and each yardstick at the scan's shape (P = 16, B = 2^18) gets
  three times: back to back (CUDA events around calls issued one after
  the other; where the host is slower than the device, this is the
  host's rate), on the device (the same with the host ahead of the device
  behind a spin kernel), and on the host (us per call, no synchronize).
  The yardsticks, which the port never calls: the plain versions, one
  ``torch.add``, the chain the fused merge replaces (``torch.add`` and the
  five launches of the v5 step's global sums), one ``index_add_`` of a
  prebuilt ``[B, 7]`` contribution tensor, and the two ways to get the
  current stream's handle;
- identity: the port's CLI at partitions=4, messages=200000, keys=50000
  with the 2^32-slot alive bitmap: wire v5 and wire v4, each on ``cuda``
  and on ``cpu``, and v5 with ``--alive-compaction off`` on ``cuda``.
  All five reports must be byte-identical apart from the two timing
  lines, and each ``cuda`` run must launch its wire format's kernel;
- scan: the full-size scan (partitions=16, messages=1000000,
  keys=3000000: 16M records, 512 MiB alive bitmap, per-partition HLL and
  quantiles) on ``cuda`` through the CLI's own setup, engine and backend,
  once in wire v5 and once in wire v4.  Both kernels' launch counters are
  zeroed just before each scan and read just after: the wire format's
  kernel must have launched once per dispatch and the other kernel never.
  The two reports must be byte-identical apart from the timing lines.

Prints the card's name and power limit (``nvidia-smi``), a ``kernels``
JSON line (each kernel's back-to-back ``ms``, ``device_ms`` and
``host_us`` beside its plain version, its library call and its bound, and
for ``counters_merge`` the chain's ``chain_ms``), and as its last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

#: Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the
#: non-tensor-core fp32 rate as the rate of a CUDA-core integer add.
PEAK_BYTES_PER_S = 3.35e12
PEAK_SIMT_OPS_PER_S = 67e12

FULL_PARTITIONS = 16
FULL_MESSAGES = 1_000_000
FULL_SPEC = f"partitions={FULL_PARTITIONS},messages={FULL_MESSAGES},keys=3000000"
IDENTITY_SPEC = "partitions=4,messages=200000,keys=50000"
ALIVE_BITS = 32
SKETCH_FLAGS = [
    "-c", "--distinct-keys-per-partition", "--quantiles-per-partition",
    "--pallas", "--alive-bitmap-bits", str(ALIVE_BITS),
]


def fail(msg: str) -> "None":
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 20) -> float:
    """Back-to-back time of ``fn()`` in ms: CUDA events around ``iters``
    calls issued one after the other.  Where the host takes longer to
    enqueue a call than the device takes to run it, this is the host's
    enqueue rate."""
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


def host_us(fns: dict, calls: dict, reps: int = 7) -> dict:
    """Host cost of one call of each of ``fns`` (label → fn) in
    microseconds: the host clock around ``calls[label]`` calls with no
    synchronize, over the calls.  The functions take turns, ``reps`` times,
    so that a drift of the shared host's speed falls on all of them; the
    median of each function's runs."""
    import torch

    for fn in fns.values():
        for _ in range(10):
            fn()
    runs = {label: [] for label in fns}
    for _ in range(reps):
        for label, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls[label]):
                fn()
            runs[label].append((time.perf_counter() - t0) * 1e6 / calls[label])
    torch.cuda.synchronize()
    return {label: statistics.median(r) for label, r in runs.items()}


def device_ms(fn, iters: int) -> "tuple[float, int, int]":
    """Device time of one call of ``fn()`` in ms, with the host ahead of
    the device: a spin kernel (``torch.cuda._sleep``) is enqueued first, so
    the host enqueues the start event, the ``iters`` calls and the end event
    before the device reaches them; the events then time the kernels and
    the gaps between them, with no host cost in it.  The spin starts at
    four times the host's time for the calls (at 2 GHz).  Where the start
    event has already passed when the host has enqueued everything, the
    spin was too short or the launch queue was full: the spin is raised
    fourfold and the calls halved, and said so.  Returns (ms, spin cycles,
    calls)."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    cycles = int(4 * (time.perf_counter() - t0) * 2e9) + 1_000_000
    torch.cuda.synchronize()
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()  # the spin had not ended
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters, cycles, iters
        print(f"time: the spin of {cycles} cycles ended before the host had "
              f"enqueued {iters} calls; raising it fourfold, halving the calls")
        cycles *= 4
        iters = max(2, iters // 2)
    fail("device_ms: the host never got ahead of the device")


def three_times(cases, b2b_iters: int) -> dict:
    """Back-to-back ms, device ms and host us per call for each case
    ``(label, fn, launches per call)``; one printed line each.  The device
    and host runs make at most about 400 launches, well inside the
    device's queue of pending launches."""
    out = {}
    for label, fn, launches in cases:
        out[label] = t = {"ms": cuda_ms(fn, b2b_iters)}
        t["device_ms"], t["spin"], t["calls"] = device_ms(
            fn, max(4, 400 // launches)
        )
    hosts = host_us(
        {label: fn for label, fn, _ in cases},
        {label: max(10, 400 // launches) for label, _, launches in cases},
    )
    for label, t in out.items():
        t["host_us"] = hosts[label]
        print(f"time: {label}: back-to-back {t['ms']:.6f} ms, device "
              f"{t['device_ms']:.6f} ms ({t['calls']} calls behind a spin of "
              f"{t['spin']} cycles), host {t['host_us']:.3f} us/call")
    return out


def bound(nbytes: int, ops: int) -> "tuple[float, str]":
    """The least time the card could take (ms) and what sets it."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_SIMT_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


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


def scalars(torch):
    """A pair of global-sum scalars on the card, started near I64_MAX so
    the sums wrap."""
    i64_max = (1 << 63) - 1
    return [torch.tensor(i64_max - 12345, dtype=torch.int64, device="cuda")
            for _ in range(2)]


def phase_kernel(torch, np, cm) -> dict:
    """``counters_merge`` against its plain version, global sums included,
    then its times at the scan's shape."""
    rng = np.random.default_rng(20261016)
    worst = 0
    for p in (1, 16, 300, 32767):
        a, d = merge_tables(p, rng)
        acc = torch.from_numpy(a).cuda()
        delta = torch.from_numpy(d).cuda()
        want_sums, got_sums = scalars(torch), scalars(torch)
        want = cm.counters_merge_plain(acc, delta, *want_sums)
        got = cm.counters_merge(acc.clone(), delta, *got_sums)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        sums = [(int(w), int(g)) for w, g in zip(want_sums, got_sums)]
        print(f"kernel: counters_merge P={p}: max_abs_err={err}, sums "
              f"(plain, kernel) {sums}")
        if not torch.equal(got, want):
            fail(f"counters_merge disagrees with its plain version at P={p}")
        if any(w != g for w, g in sums):
            fail(f"counters_merge's global sums disagree at P={p}: {sums}")
        worst = max(worst, err)

    p = 16  # the scan phase's shape
    a, d = merge_tables(p, rng)
    acc = torch.from_numpy(a).cuda()
    delta = torch.from_numpy(d).cuda()
    out = torch.empty_like(acc)
    size, count = scalars(torch)
    label = "counters_merge+sums"

    def chain():
        # The PyTorch calls the fused launch replaces: the add and the
        # v5 step's five launches of global sums.
        torch.add(acc, delta, out=out)
        size.add_(torch.sum(delta[:, 5] + delta[:, 6]))
        count.add_(torch.sum(delta[:, 0]))

    raw = torch._C._cuda_getCurrentRawStream
    cases = [
        (label, lambda: cm.counters_merge(acc, delta, overall_size=size,
                                          overall_count=count), 1),
        (f"{label} plain",
         lambda: cm.counters_merge_plain(acc, delta, size, count), 6),
        ("torch.add", lambda: torch.add(acc, delta, out=out), 1),
        ("chain: torch.add + 5 sum launches", chain, 6),
        ("stream handle: torch.cuda.current_stream().cuda_stream",
         lambda: torch.cuda.current_stream().cuda_stream, 1),
        ("stream handle: torch._C._cuda_getCurrentRawStream(0)",
         lambda: raw(0), 1),
    ]
    t = three_times([(f"{c[0]} P={p}",) + c[1:] for c in cases], 2000)
    kernel, plain = t[f"{label} P={p}"], t[f"{label} plain P={p}"]
    library = t[f"torch.add P={p}"]
    chain_t = t[f"chain: torch.add + 5 sum launches P={p}"]
    # Two tables read, one written, two scalars read and written.  One add
    # per cell, and the sums' three adds per row.
    nbytes = 3 * 8 * 7 * p + 2 * 2 * 8
    ops = 7 * p + 3 * p
    bound_ms, bound_by = bound(nbytes, ops)
    row = {
        "name": "counters_merge",
        "route": "cuda",
        "source": "kafka_topic_analyzer_tpu_torch/csrc/counters_merge.cu",
        "replaces": "kafka_topic_analyzer_tpu/ops/pallas_counters.py:216",
        "launches": 0,
        "max_abs_err": worst,
        "ms": kernel["ms"],
        "plain_ms": plain["ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library["ms"],
        "device_ms": kernel["device_ms"],
        "host_us": kernel["host_us"],
        "chain_ms": chain_t["ms"],
    }
    print(
        f"kernel: {label} P={p}: {kernel['ms']:.6f} ms, plain "
        f"{plain['ms']:.6f} ms, torch.add {library['ms']:.6f} ms, chain "
        f"{chain_t['ms']:.6f} ms, bound {bound_ms:.9f} ms ({nbytes} B); host "
        f"{kernel['host_us']:.3f} us/call against torch.add's "
        f"{library['host_us']:.3f} ({kernel['host_us'] / library['host_us']:.3f}x)"
    )
    return row


def update_inputs(torch, np, p: int, b: int, rng, order: str = "random"):
    """The wire-v4 update's inputs on the card: int32 partition, key and
    value lengths (key lengths over the whole u16 range, value lengths up
    to the reference's 2^24 - 1 cap, some at it), bool flags.  ``order``:
    ``random`` partitions with a valid prefix of 90% of the records (an
    invalid tail); ``round-robin``, the scan's own record order, and
    ``runs``, runs of one partition as a Kafka fetch delivers them, both
    with a full batch."""
    if order == "random":
        partition = rng.integers(0, p, size=b, dtype=np.int32)
        valid = np.arange(b) < (b * 9) // 10
    else:
        partition = (
            np.arange(b) % p if order == "round-robin" else np.arange(b) * p // b
        ).astype(np.int32)
        valid = np.ones(b, dtype=bool)
    value_len = rng.integers(0, 1 << 24, size=b, dtype=np.int32)
    value_len[:64] = (1 << 24) - 1
    cols = [
        partition,
        rng.integers(0, 1 << 16, size=b, dtype=np.int32),
        value_len,
        rng.random(b) < 0.1,
        rng.random(b) < 0.15,
        valid,
    ]
    per = rng.integers(-(1 << 62), 1 << 62, size=(p, 7), dtype=np.int64)
    return torch.from_numpy(per).cuda(), [torch.from_numpy(c).cuda() for c in cols]


ORDERS = ("random", "round-robin", "runs")


def phase_update_kernel(torch, np, cu) -> dict:
    """``counters_update`` against its plain version, global sums included,
    in every record order, then its times at the scan's shape."""
    rng = np.random.default_rng(20261017)
    b = 1 << 18
    worst = 0
    for p in (1, 16, 300, 877, 4096, 32767):
        for order in ORDERS:
            per, cols = update_inputs(torch, np, p, b, rng, order)
            want_sums, got_sums = scalars(torch), scalars(torch)
            want = cu.counters_update_plain(per, *cols, p, *want_sums)
            got = cu.counters_update(per.clone(), *cols, p, *got_sums)
            torch.cuda.synchronize()
            err = int((got - want).abs().max().item())
            sums = [(int(w), int(g)) for w, g in zip(want_sums, got_sums)]
            print(f"kernel: counters_update P={p} B={b} {order}: "
                  f"max_abs_err={err}, sums (plain, kernel) {sums}")
            if not torch.equal(got, want):
                fail(f"counters_update disagrees with its plain version at "
                     f"P={p} in {order} order")
            if any(w != g for w, g in sums):
                fail(f"counters_update's global sums disagree at P={p} in "
                     f"{order} order: {sums}")
            worst = max(worst, err)

    p = 16  # the scan phase's shape and record order
    size, count = scalars(torch)
    label = "counters_update+sums"
    inputs = {order: update_inputs(torch, np, p, b, rng, order)
              for order in ("round-robin", "runs", "random")}
    per, cols = inputs["round-robin"]
    partition, key_len, value_len, key_null, value_null, valid = cols
    # The library yardstick: one index_add_ of the prebuilt contributions
    # (what the plain version computes before its add), never called by
    # the port.
    kn, vn = valid & ~key_null, valid & ~value_null
    contrib = torch.stack(
        [valid, valid & value_null, vn, valid & key_null, kn,
         torch.zeros_like(valid), torch.zeros_like(valid)], dim=1,
    ).to(torch.int64)
    contrib[:, 5] = torch.where(kn, key_len, 0)
    contrib[:, 6] = torch.where(vn, value_len, 0)
    idx = torch.where(valid, partition.to(torch.int64), p)
    acc = torch.zeros((p + 1, 7), dtype=torch.int64, device=per.device)

    def kernel_on(order):
        # Explicit arguments, as the step passes them.
        per, (c0, c1, c2, c3, c4, c5) = inputs[order]
        return lambda: cu.counters_update(
            per, c0, c1, c2, c3, c4, c5, p,
            overall_size=size, overall_count=count,
        )

    t = three_times([
        (f"{label} P={p} B={b} round-robin", kernel_on("round-robin"), 1),
        (f"{label} P={p} B={b} runs", kernel_on("runs"), 1),
        (f"{label} P={p} B={b} random", kernel_on("random"), 1),
        (f"{label} plain P={p} B={b} round-robin",
         lambda: cu.counters_update_plain(per, *cols, p, size, count), 25),
        (f"index_add_ of a prebuilt [B, 7] P={p} B={b}",
         lambda: acc.index_add_(0, idx, contrib), 1),
    ], 500)
    times = {order: t[f"{label} P={p} B={b} {order}"]
             for order in ("round-robin", "runs", "random")}
    plain = t[f"{label} plain P={p} B={b} round-robin"]
    library = t[f"index_add_ of a prebuilt [B, 7] P={p} B={b}"]
    # Each column read once (three int32, three bool), the table and the
    # two scalars read and written once; seven integer adds per record, and
    # three more for the sums.
    nbytes = b * (3 * 4 + 3 * 1) + 2 * 8 * 7 * p + 2 * 2 * 8
    ops = 7 * b + 3 * b
    bound_ms, bound_by = bound(nbytes, ops)
    kernel = times["round-robin"]
    row = {
        "name": "counters_update",
        "route": "cuda",
        "source": "kafka_topic_analyzer_tpu_torch/csrc/counters_update.cu",
        "replaces": "kafka_topic_analyzer_tpu/ops/pallas_counters.py:52",
        "launches": 0,
        "max_abs_err": worst,
        "ms": kernel["ms"],
        "plain_ms": plain["ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library["ms"],
        "device_ms": kernel["device_ms"],
        "host_us": kernel["host_us"],
    }
    print(
        f"kernel: {label} P={p} B={b}: {kernel['ms']:.6f} ms (runs of one "
        f"partition {times['runs']['ms']:.6f} ms, random order "
        f"{times['random']['ms']:.6f} ms), plain {plain['ms']:.6f} ms, "
        f"index_add_ {library['ms']:.6f} ms, bound {bound_ms:.9f} ms ({nbytes} "
        f"B, {ops} adds); device {kernel['device_ms']:.6f} ms = "
        f"{bound_ms / kernel['device_ms']:.4f} of the bound"
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


def zero(kernels) -> None:
    for fn in kernels.values():
        fn.launches = 0


def phase_identity(main, kernels) -> None:
    """Five CLI runs of one topic; every report must equal the first
    (timing lines aside) and every gpu run must launch its wire format's
    kernel and not the other."""
    argv = ["-t", "smoke", "--source", "synthetic", "--synthetic",
            IDENTITY_SPEC, *SKETCH_FLAGS]
    runs = [
        ("v5", [], "gpu", "counters_merge"),
        ("v5", [], "cpu", None),
        ("v4", ["--wire-format", "v4"], "gpu", "counters_update"),
        ("v4", ["--wire-format", "v4"], "cpu", None),
        ("v5 compaction off", ["--alive-compaction", "off"], "gpu",
         "counters_merge"),
    ]
    first = None
    for label, flags, backend, kernel in runs:
        zero(kernels)
        t0 = time.perf_counter()
        out = drop_timing(run_cli(main, argv + flags + ["--backend", backend]))
        secs = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
        print(f"identity: {label} on {backend}: {secs:.3f} s, launches {launches}")
        for name, n in launches.items():
            if (name == kernel) != (n > 0):
                fail(f"identity: {label} on {backend} launched {name} {n} times")
        if first is None:
            first = out
        elif out != first:
            fail(f"identity: the {label} report on {backend} differs from "
                 f"the v5 gpu report:\n{first}\n{out}")
    print("identity: v5, v4 and compaction-off reports byte-identical on cuda "
          "and cpu (timing lines aside)")


def phase_scan(torch, np, cli, kernels, label, flags, kernel):
    """One full-size scan on the card; returns (launches of ``kernel``,
    the report without its timing lines)."""
    from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
    from kafka_topic_analyzer_tpu_torch.engine import run_scan
    from kafka_topic_analyzer_tpu_torch.report import render_report

    argv = ["-t", "scan", "--source", "synthetic", "--synthetic", FULL_SPEC,
            *SKETCH_FLAGS, *flags, "--backend", "gpu"]
    args = cli.build_parser().parse_args(argv)
    source, config = cli.setup(args)
    backend = TorchBackend(config, device=args.backend)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero(kernels)
    t0 = time.perf_counter()
    result = run_scan(args.topic, source, backend, args.batch_size)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    m = result.metrics
    records = source.total_records()
    words = backend.state.alive.words
    dispatches = math.ceil(records / config.batch_size)
    print(f"scan {label}: {records} records in {wall:.3f} s = "
          f"{records / wall:.1f} records/s; {backend.dispatches} dispatches, "
          f"kernel launches {launches}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B")
    report = render_report(
        args.topic, m, result.start_offsets, result.end_offsets,
        result.duration_secs, show_alive_keys=True,
    )
    sys.stdout.write(report)
    want = FULL_PARTITIONS * FULL_MESSAGES
    if m.overall_count != want or records != want:
        fail(f"scan {label}: overall_count {m.overall_count} != {want}")
    if any(m.total(p) != FULL_MESSAGES for p in m.partitions):
        fail(f"scan {label}: a partition total is not {FULL_MESSAGES}")
    if words.device.type != "cuda" or words.numel() != 1 << (ALIVE_BITS - 5):
        fail(f"scan {label}: alive bitmap is {words.numel()} words on "
             f"{words.device}")
    n = launches[kernel]
    if not (n > 0 and n == backend.dispatches == dispatches):
        fail(f"scan {label}: {n} {kernel} launches for {backend.dispatches} "
             f"dispatches (expected {dispatches})")
    if any(v for name, v in launches.items() if name != kernel):
        fail(f"scan {label}: launched a kernel of the other wire format: "
             f"{launches}")
    hll = m.distinct_keys_hll_per_partition
    if not (m.alive_keys and all(math.isfinite(h) and h > 0 for h in hll)):
        fail(f"scan {label}: alive keys or HLL estimates missing")
    if int(np.sum(m.per_partition[:, 2])) < m.alive_keys:
        fail(f"scan {label}: more alive keys than alive records")
    breakdown(torch, source, config, wall, backend.dispatches, label)
    return n, drop_timing(report)


def breakdown(torch, source, config, wall: float, dispatches: int,
              label: str) -> None:
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
        f"breakdown {label}: per dispatch of {config.batch_size} records: wall "
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
        from kafka_topic_analyzer_tpu_torch.ops import counters_update as cu
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
    names = list(_build.KERNEL_SOURCES)
    with ThreadPoolExecutor(len(names)) as pool:
        logs = dict(zip(names, pool.map(_build.build, names)))
    print(f"build: {time.perf_counter() - t0:.3f} s for {len(logs)} kernel(s)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")

    kernels = {"counters_merge": cm.counters_merge,
               "counters_update": cu.counters_update}
    merge_row = phase_kernel(torch, np, cm)
    update_row = phase_update_kernel(torch, np, cu)
    phase_identity(cli.main, kernels)
    merge_row["launches"], v5_report = phase_scan(
        torch, np, cli, kernels, "v5", [], "counters_merge"
    )
    update_row["launches"], v4_report = phase_scan(
        torch, np, cli, kernels, "v4", ["--wire-format", "v4"], "counters_update"
    )
    if v4_report != v5_report:
        fail("scan: the v4 and v5 reports differ (timing lines aside)")
    print("scan: v4 and v5 reports byte-identical (timing lines aside)")
    print(json.dumps({"kernels": [merge_row, update_row]}))
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
