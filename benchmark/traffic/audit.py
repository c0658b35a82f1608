"""Traffic ``audit``: a closed loop of whole audits, one at a time, back to
back, as an operator's audit script runs them.

Each audit is one in-process call of the program's CLI entry
(``kafka_topic_analyzer_tpu_torch.cli.main``) with the configuration's
arguments and ``--json``: connect, metadata, the backend's construction,
the scan, finalize and the report. Its standard output, the report, is
captured, so nothing follows the benchmark's own result line.

Set-up starts the topic's broker and runs one audit to warm up. The window
then runs audits until ``seconds`` have passed; the last may run past it.
The audits' rate, the records of all the window's audits that exited 0
over the time from the window's start to the end of its last audit, goes
to the per-layer reader ``audit_records_per_s.scan``; the end-to-end
metrics are the harness's (``setup_s`` from here, the device's memory
peak). Parameters in the cell's file: none besides its ``limits``.
"""

from __future__ import annotations

import contextlib
import io
import json
import time

from benchmark import probes
from benchmark.gen.broker import BrokerProcess
from benchmark.gen.topic import Topic


def audit(argv: "list[str]") -> "tuple[int, dict | None]":
    """One CLI run: its exit code and its ``--json`` document."""
    from kafka_topic_analyzer_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    lines = out.getvalue().strip().splitlines()
    try:
        doc = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        doc = None
    return rc, doc


def run(ctx) -> dict:
    topic_name = "bench-" + ctx.config["name"]
    windows = ctx.config["topic"]["records_per_partition"] // ctx.config["topic"]["records_per_batch"]
    P = ctx.config["topic"]["partitions"]
    records = P * windows * ctx.config["topic"]["records_per_batch"]
    with BrokerProcess(ctx.config, ctx.seed, topic_name, windows) as broker:
        ctx.init_device()  # while the broker builds its templates
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
    topic = Topic(ctx.config, ctx.seed, name=topic_name)
    return {
        "setup_s": setup_s,
        "metrics": {},
        "attempted": len(docs),
        "failed": len(docs) - sum(ok),
        # Every audit reads the whole topic: one reference judges them all.
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
