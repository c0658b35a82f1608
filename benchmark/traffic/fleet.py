"""Traffic ``fleet``: a closed loop of whole fleet audits of a cluster, one
at a time, back to back, as an operator's audit script runs them.

The cluster (`benchmark.gen.cluster`) serves the configuration's topics:
the TPC-C change-data-capture topics of `benchmark.gen.tpcc_cdc`. Each
audit is one in-process call of the program's CLI entry with the
configuration's arguments (``--fleet`` and its include globs among them)
and ``--json`` (`traffic.audit.audit`): discovery, admission, a pass a
topic on a backend of its own, the rollup and each topic's document.

Set-up starts the cluster, starts CUDA and builds the judge's copy of the
topics while the cluster builds its own, and runs one fleet audit to warm
up. The window then runs audits until ``seconds`` have passed; the last
may run past it. Every topic's document of every audit that exited 0 is
judged against the reference for that topic. The readers get the
window's counters, the program's gauges at its close, the audits'
records, walls and spans, and in a traced run the topics' passes
(``fleet-pass`` spans: start, end, topic). Parameters in the cell's file:
none besides its ``limits``.
"""

from __future__ import annotations

import time

from benchmark import probes
from benchmark.gen.cluster import ClusterProcess
from benchmark.gen.tpcc_cdc import TpccCdc
from benchmark.traffic.audit import audit


class _FleetTrace(probes.DeviceTrace):
    """`probes.DeviceTrace`, keeping also the fleet's topic passes."""

    def __exit__(self, *exc) -> None:
        super().__exit__(*exc)
        self.passes: "list[tuple[float, float, str]]" = []
        if not self.enabled:
            return
        t0 = self._tracer._t0
        self.passes = [
            (t0 + e["ts"] / 1e6, t0 + (e["ts"] + e["dur"]) / 1e6, e["args"].get("topic"))
            for e in self._tracer.events()
            if e.get("ph") == "X" and e.get("name") == "fleet-pass"
        ]


def _documents(doc: "dict | None") -> dict:
    return (doc or {}).get("topics") or {}


def run(ctx) -> dict:
    with ClusterProcess(ctx.config, ctx.seed) as cluster:
        ctx.init_device()
        db = TpccCdc(ctx.config, ctx.seed)  # the judge's, while the cluster builds its own
        cluster.wait_ready()
        ctx.log(f"cluster up at {time.monotonic() - ctx.t_start:.3f} s")
        argv = ["-b", cluster.bootstrap, "--json", "--quiet", *ctx.argv]
        rc, doc = audit(argv)
        if rc != 0 or len(_documents(doc)) != len(db.topics):
            raise RuntimeError(f"the warm-up fleet audit failed (exit {rc})")
        setup_s = time.monotonic() - ctx.t_start
        ctx.log(f"warm fleet audit done at {setup_s:.3f} s")
        before = probes.counters()
        spans, docs, codes = [], [], []
        with _FleetTrace(ctx.trace, ctx.tmpdir, ctx.cuda) as trace:
            t0 = time.monotonic()
            while True:
                a = time.monotonic()
                rc, doc = audit(argv)
                b = time.monotonic()
                spans.append((a, b))
                docs.append(doc)
                codes.append(rc)
                if b - t0 >= ctx.seconds:
                    break
        t1 = b
        walls = [b - a for a, b in spans]
        ctx.log("fleet audit walls " + " ".join(f"{w:.3f}" for w in walls))
        ok = [rc == 0 for rc in codes]
        records = sum(t.records for t in db.topics)
        ctx.log(f"records_per_s {records * sum(ok) / (t1 - t0):.1f}")
        ctx.synchronize()
        after = probes.counters()
        counters = probes.delta(before, after)
    good = [_documents(d) for d, g in zip(docs, ok) if g]
    return {
        "setup_s": setup_s,
        "metrics": {},
        "attempted": len(docs),
        "failed": len(docs) - sum(ok),
        # Every audit reads every topic whole: one reference a topic.
        "judge": [(t, t.heads, [d.get(t.name) for d in good]) for t in db.topics],
        "layer": {
            "counters": counters,
            "gauges": after,
            "walls": walls,
            "audits": spans,
            "passes": trace.passes,
            "records": records * sum(ok),
            "window_s": t1 - t0,
            "device": trace.summary(t0, t1) if ctx.trace else None,
        },
        "broker_cpu_s": cluster.cpu_s,
    }
