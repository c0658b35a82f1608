"""Staged bring-up probe: name the stage where a device workload stops
(port of the reference's ``tools/tunnel_probe.py``).

    python -m kafka_topic_analyzer_tpu_torch.tools.tunnel_probe [--stop-after STAGE]

Stages, in order: ``init`` (CUDA init and the card's name), ``put1`` (a
small host→device copy), ``jit1`` (build, load and launch the
``counters_merge`` kernel once), ``put20m`` (a 20 MiB copy), ``step-compile``
(the first `backends.gpu.TorchBackend` step: pack, copy, fold) and
``steps`` (8 more).  A card has no tunnel, but a fresh card, a broken
CUDA install or a kernel that does not build stops at one of these: each stage
prints a flushed line with its latency before the next starts, so the
last line that made it out names it.  The last stdout line is one JSON
object with each stage's seconds.

With ``--device cpu`` the stages that need a card (``jit1``, ``put20m``)
are skipped with a stderr line, ``put1`` is a host copy and the steps run
the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

STAGES = ["init", "put1", "jit1", "put20m", "step", "steps"]


def _stage(name, report: dict):
    print(f"probe: [{name}] start", file=sys.stderr, flush=True)
    t0 = time.perf_counter()

    def done(extra: str = "") -> None:
        dt = time.perf_counter() - t0
        report[name] = round(dt, 4)
        print(
            f"probe: [{name}] ok in {dt:.2f}s {extra}",
            file=sys.stderr, flush=True,
        )

    return done


def _skip(name: str, why: str, report: dict) -> None:
    report[name] = "skipped"
    print(f"probe: [{name}] skipped: {why}", file=sys.stderr, flush=True)


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stop-after", default="steps", choices=STAGES)
    ap.add_argument("--batch-size", type=int, default=1 << 20)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the probe runs (cuda fails without a card)")
    args = ap.parse_args(argv)
    stages: dict = {}
    doc = {"stages": stages}

    def emit() -> int:
        print(json.dumps(doc), flush=True)
        return 0

    done = _stage("init", stages)
    import numpy as np
    import torch

    from kafka_topic_analyzer_tpu_torch._torch_support import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    if on_card:
        torch.cuda.init()
    doc["device"] = torch.cuda.get_device_name(dev) if on_card else "cpu"
    doc["platform"] = "gpu" if on_card else "cpu"
    done(f"device={dev} {doc['device']}")
    if args.stop_after == "init":
        return emit()

    done = _stage("put1", stages)
    torch.arange(8, dtype=torch.int32).to(dev)
    sync()
    done()
    if args.stop_after == "put1":
        return emit()

    if on_card:
        from kafka_topic_analyzer_tpu_torch.ops.counters_merge import counters_merge

        done = _stage("jit1", stages)
        table = torch.zeros((4, 7), dtype=torch.int64, device=dev)
        counters_merge(table, torch.ones_like(table))
        sync()
        done(f"sum={int(table.sum())}")
    else:
        _skip("jit1", "no card: no kernel to build or launch", stages)
    if args.stop_after == "jit1":
        return emit()

    if on_card:
        done = _stage("put20m", stages)
        big = torch.from_numpy(np.random.default_rng(0).integers(
            0, 255, size=20 << 20, dtype=np.uint8
        ))
        t0 = time.perf_counter()
        big.to(dev)
        sync()
        dt = time.perf_counter() - t0
        done(f"{big.numel() / dt / 1e9:.3f} GB/s")
    else:
        _skip("put20m", "no card: a host-to-host copy is no transfer", stages)
    if args.stop_after == "put20m":
        return emit()

    done = _stage("step-compile", stages)
    from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
    from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
    from kafka_topic_analyzer_tpu_torch.io import native
    from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSpec

    config = AnalyzerConfig(num_partitions=4, batch_size=args.batch_size)
    spec = SyntheticSpec(
        num_partitions=4,
        messages_per_partition=args.batch_size // 4,
        keys_per_partition=10_000,
        seed=0xBEEF,
    )
    src = native.NativeSyntheticSource(spec)
    batch = next(iter(src.batches(args.batch_size))).pad_to(args.batch_size)
    backend = TorchBackend(config, init_now_s=0, device=dev, use_native=True)
    backend.update(batch)
    backend.drain_dispatch()
    sync()
    done()
    if args.stop_after == "step":
        return emit()

    done = _stage("steps", stages)
    t0 = time.perf_counter()
    n = 8
    for _ in range(n):
        backend.update(batch)
    backend.drain_dispatch()
    sync()
    dt = time.perf_counter() - t0
    doc["steps_msgs_per_sec"] = round(n * args.batch_size / dt, 1)
    done(f"{n * args.batch_size / dt / 1e6:.2f}M rec/s")
    return emit()


if __name__ == "__main__":
    sys.exit(main())
