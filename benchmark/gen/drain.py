"""How fast the benchmark's broker serves a configuration's topic to a
plain consumer, which only reads the bytes and steps over the batches:
the rate the broker can give any client.

    python3 benchmark/gen/drain.py --config benchmark/configs/<name>.json \\
        --consumers 16 --passes 3 --seed 1

Each of ``--consumers`` processes reads every partition ``p`` with
``p % consumers == its index`` from its leader, ``--passes`` times, with
Fetch v4 (64 MiB a request, 8 MiB a partition, the analyzer's defaults)
through ``drain.c``: one thread and connection a partition, each
response read into one reused buffer. One JSON line: records/s and GB/s
(10^9 bytes) from the first consumer's start to the last one's end, and
the broker's CPU seconds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import multiprocessing
import sys
import threading
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.gen.broker import BrokerProcess  # noqa: E402
from benchmark.gen.cbuild import library  # noqa: E402

MAX_BYTES, PARTITION_MAX_BYTES = 64 << 20, 8 << 20


def native_lib() -> ctypes.CDLL:
    """``drain.c``, built and loaded: ``bench_drain(port, topic, partition,
    end, max_bytes, partition_max_bytes, &nbytes)``."""
    lib = library(Path(__file__).resolve().with_name("drain.c"))
    lib.bench_drain.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64,
                                ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64)]
    lib.bench_drain.restype = ctypes.c_int64
    return lib


def consume(pipe, ports, topic: str, parts, end: int, passes: int) -> None:
    """Read ``parts`` to ``end`` ``passes`` times, one thread a partition;
    send (start, end, bytes), bytes None if a partition failed."""
    lib = native_lib()
    got = {}

    def one(p: int) -> None:
        total = 0
        for _ in range(passes):
            n = ctypes.c_int64(0)
            off = lib.bench_drain(ports[p % len(ports)], topic.encode(), p, end,
                                  MAX_BYTES, PARTITION_MAX_BYTES, ctypes.byref(n))
            if off != end:
                got[p] = None
                return
            total += n.value
        got[p] = total

    threads = [threading.Thread(target=one, args=(p,)) for p in parts]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    t1 = time.monotonic()
    failed = any(v is None for v in got.values())
    pipe.send((t0, t1, None if failed else sum(got.values())))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--consumers", type=int, default=7)
    ap.add_argument("--passes", type=int, default=1, help="times each partition is read")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    config = json.loads(Path(args.config).read_text())
    t = config["topic"]
    windows = t["records_per_partition"] // t["records_per_batch"]
    end = windows * t["records_per_batch"]
    with BrokerProcess(config, args.seed, "drain", windows) as broker:
        t0 = time.monotonic()
        ports = broker.wait_ready()
        built = time.monotonic() - t0
        ctx = multiprocessing.get_context("spawn")
        procs, pipes, ends = [], [], []
        for k in range(args.consumers):
            parent, child = ctx.Pipe()
            parts = [p for p in range(t["partitions"]) if p % args.consumers == k]
            procs.append(ctx.Process(target=consume,
                                     args=(child, ports, "drain", parts, end, args.passes)))
            pipes.append(parent)
            ends.append(child)
        for p in procs:
            p.start()
        for child in ends:
            child.close()  # so a consumer that dies reads as EOF, not a hang
        spans = [pipe.recv() for pipe in pipes]
        for p in procs:
            p.join()
    if any(n is None for _, _, n in spans):
        print("error: a consumer failed", file=sys.stderr)
        return 1
    # From the first consumer's start to the last one's end: the processes'
    # own start-up is left out.
    wall = max(b for _, b, _ in spans) - min(a for a, _, _ in spans)
    records = t["partitions"] * end * args.passes
    print(json.dumps({
        "config": config["name"], "consumers": args.consumers, "passes": args.passes,
        "records": records, "records_per_s": records / wall,
        "gb_per_s": sum(n for _, _, n in spans) / wall / 1e9,
        "wall_s": wall, "broker_build_s": built, "broker_cpu_s": broker.cpu_s,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
