"""Traffic ``audit_compressed``: the closed loop of ``audit`` (whole audits,
one at a time, back to back, through the program's CLI entry with the
configuration's arguments and ``--json``) against a broker that serves the
topic's batches compressed (`benchmark.gen.compressed`: the codec the
configuration's ``topic.compression`` names, the values its
``topic.values`` names).

Set-up starts that broker, which builds the templates and then compresses
them, and runs one audit to warm up; the window, its rate
(``audit_records_per_s.*``), the judge (one reference of the whole topic,
which compression does not change) and the end-to-end metrics are the
``audit`` traffic's. Parameters in the cell's file: none besides its
``limits``.
"""

from __future__ import annotations

import time

from benchmark import probes
from benchmark.gen.compressed import CompressedBrokerProcess
from benchmark.gen.topic import Topic
from benchmark.traffic.audit import audit


def run(ctx) -> dict:
    topic_name = "bench-" + ctx.config["name"]
    t = ctx.config["topic"]
    windows = t["records_per_partition"] // t["records_per_batch"]
    P = t["partitions"]
    records = P * windows * t["records_per_batch"]
    with CompressedBrokerProcess(ctx.config, ctx.seed, topic_name, windows) as broker:
        ctx.init_device()  # while the broker builds and compresses its templates
        broker.wait_ready()
        ctx.log(f"broker up at {time.monotonic() - ctx.t_start:.3f} s")
        argv = ["-t", topic_name, "-b", broker.bootstrap, "--json", "--quiet", *ctx.argv]
        rc, _ = audit(argv)
        if rc != 0:
            raise RuntimeError(f"the warm-up audit failed (exit {rc})")
        setup_s = time.monotonic() - ctx.t_start
        ctx.log(f"warm audit done at {setup_s:.3f} s")
        before = probes.counters()
        walls, docs, codes = [], [], []
        with probes.DeviceTrace(ctx.trace, ctx.tmpdir, ctx.cuda) as trace:
            t0 = time.monotonic()
            while True:
                a = time.monotonic()
                rc, doc = audit(argv)
                b = time.monotonic()
                walls.append(b - a)
                docs.append(doc)
                codes.append(rc)
                if b - t0 >= ctx.seconds:
                    break
        t1 = b
        ctx.log("audit walls " + " ".join(f"{w:.3f}" for w in walls))
        ok = [rc == 0 for rc in codes]
        ctx.log(f"records_per_s {records * sum(ok) / (t1 - t0):.1f}")
        ctx.synchronize()
        counters = probes.delta(before, probes.counters())
    wire = counters.get("kta_fetch_bytes_total", 0.0)
    ctx.log(f"fetched {wire / max(1, len(docs)):.0f} B an audit")
    topic = Topic(ctx.config, ctx.seed, name=topic_name)
    return {
        "setup_s": setup_s,
        "metrics": {},
        "attempted": len(docs),
        "failed": len(docs) - sum(ok),
        "judge": [(topic, [windows] * P, [d for d, good in zip(docs, ok) if good])],
        "layer": {
            "counters": counters,
            "walls": walls,
            "records": records * sum(ok),
            "window_s": t1 - t0,
            "device": trace.summary(t0, t1) if ctx.trace else None,
        },
        "broker_cpu_s": broker.cpu_s,
    }
