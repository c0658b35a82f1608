"""Shared hardware measurement protocol (port of the reference's
``tools/hwmeasure.py``).

One implementation of the two measurements both ``tools/bench.py`` (the
headline JSON line) and ``tools/bench_hw.py`` (the staged campaign)
report, so the protocols cannot drift: host→device copy bandwidth, and
the analyzer-step rate (rows already on the card, or copied each step).

Bandwidth is reported from pinned memory, which is what the backend's
staging rings copy from (`backends.gpu.StagingRing`), and from pageable
memory, which is what a copy of a plain numpy array measures.  Like the
reference, a figure is MiB / 1024 per second (GiB/s) under the name
``gbps``.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from kafka_topic_analyzer_tpu_torch._torch_support import resolve_device


def measure_transfer_gbps(device=None, mib_sizes: Sequence[int] = (8,),
                          pinned: bool = True) -> dict:
    """Time one synchronous host→device copy per size, from pinned or
    pageable host memory; returns ``{MiB: GB/s}``.  The device buffer is
    allocated before the clock starts, and an untimed warmup copy pays the
    process's first-transfer setup.  Raises on a device that is not a
    card: a host-to-host copy is no transfer."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"transfer bandwidth needs a CUDA device, not {dev}")

    def host(nbytes: int) -> torch.Tensor:
        return torch.ones(nbytes, dtype=torch.uint8, pin_memory=pinned)

    warm = host(1 << 16)
    warm.to(dev)
    torch.cuda.synchronize(dev)
    out = {}
    for mib in mib_sizes:
        src = host(mib << 20)
        dst = torch.empty_like(src, device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        dst.copy_(src)
        torch.cuda.synchronize(dev)
        out[mib] = round(mib / 1024 / (time.perf_counter() - t0), 4)
        del dst
    return out


#: The size every reporter uses for its comparable `transfer_gbps` figure.
HEADLINE_TRANSFER_MIB = 8


def headline_transfer_gbps(device=None, pinned: bool = True) -> float:
    """The single-copy bandwidth reported as ``transfer_gbps`` (pinned)
    and ``transfer_gbps_pageable`` by both ``tools/bench.py`` and
    ``tools/bench_hw.py``: one policy, one key, comparable across
    reports."""
    return measure_transfer_gbps(device, (HEADLINE_TRANSFER_MIB,), pinned)[
        HEADLINE_TRANSFER_MIB
    ]


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_step_loop(
    config,
    feed,
    *,
    steps: int,
    device_resident: bool,
    device=None,
    state=None,
) -> dict:
    """Run one untimed packed analyzer step, then time ``steps`` steps,
    cycling ``feed``: packed ``uint8`` rows, tensors already on the device
    when ``device_resident``, else host rows (numpy or tensors, pinned or
    not) copied to the device each step.  The state is folded in place.

    Returns ``{"msgs_per_sec", "compile_s", "state"}``; the rate counts
    ``config.batch_size`` records per step.  Nothing is compiled, so
    ``compile_s`` is the first step's wall, which includes each kernel's
    first load."""
    from kafka_topic_analyzer_tpu_torch.backends.step import (
        analyzer_step,
        apply_pair_table,
    )
    from kafka_topic_analyzer_tpu_torch.models.state import AnalyzerState
    from kafka_topic_analyzer_tpu_torch.ops.bitmap import bitmap_scratch
    from kafka_topic_analyzer_tpu_torch.packing import (
        alive_table_mode,
        pack_pair_table,
        pair_table_capacity,
        unpack_device,
        unpack_pair_table_device,
    )

    dev = resolve_device(device)
    if state is None:
        state = AnalyzerState.init(config, dev)

    def put(buf) -> torch.Tensor:
        if device_resident:
            return buf
        return torch.as_tensor(buf).to(dev, non_blocking=True)

    # Compacted alive configs take a pair table per step.  The feed is
    # already-packed rows (no decoded batch to dedupe), so the loop ships
    # ONE shared identity (empty) table, as the reference does: the
    # device still runs the whole per-dispatch pair apply.
    pairs = None
    cap = 0
    if config.compact_alive:
        cap = pair_table_capacity(config, config.batch_size, 1)
        table = torch.from_numpy(pack_pair_table([], config, cap)[0]).to(dev)
        pairs = unpack_pair_table_device(table, config, cap)
    # Pair lists (per row, or a table in its list form) scatter through a
    # word accumulator, as in the backend.
    scratch = None
    if config.count_alive_keys and (
        not config.compact_alive or alive_table_mode(config, cap) == 1
    ):
        scratch = bitmap_scratch(config.alive_bitmap_bits, dev)

    def run(i: int) -> None:
        analyzer_step(state, unpack_device(put(feed[i % len(feed)]), config),
                      config, scratch=scratch)
        if pairs is not None:
            apply_pair_table(state, pairs, config, scratch=scratch)

    _synchronize(dev)
    t0 = time.perf_counter()
    run(0)
    _synchronize(dev)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i in range(steps):
        run(i)
    _synchronize(dev)
    dt = time.perf_counter() - t0
    return {
        "msgs_per_sec": round(steps * config.batch_size / dt, 1),
        "compile_s": round(compile_s, 2),
        "state": state,
    }
