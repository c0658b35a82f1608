"""Serving-plane referee (port of the reference's ``tools/bench_serve.py``;
DESIGN §26): what does a fleet of dashboards cost, and does the scan
notice them?

    python -m kafka_topic_analyzer_tpu_torch.tools.bench_serve \\
        [--device cuda|cpu] [--pollers N] [--hz F] [--seconds S] [--out FILE]

The follow scans run the port's `backends.gpu.TorchBackend` on
``--device`` (the first CUDA device by default), so the loaded arm's
fold launches the card's counter kernel while the pollers scrape.

Four arms, one JSON:

1. ``poll_naive`` — N pollers at ``--hz`` for ``--seconds``, no
   ``If-None-Match``, no ``Accept-Encoding``: every poll pays the full
   identity body: what a read path without validators charges every
   poller, every second.
2. ``poll_conditional`` — the SAME poller fleet using the conditional
   contract (ETag revalidation + gzip): a poll costs zero body bytes
   until the report actually changes, then one gzip body.  The
   bytes-on-wire ratio between the two arms is the headline.
3. ``scan_bare`` — a follow scan over a loopback template broker
   (`tools.bench_e2e.BrokerProcess`, a child process) with NO
   serving plane: the interference referee's denominator.
4. ``scan_loaded`` — the same scan with the WHOLE plane on (exporter +
   SSE publisher + conditional poller fleet + SSE subscribers), p50/p99
   of ``/report.json`` measured WHILE the scan folds.

Bars (recorded met-or-missed in the JSON, never silently):
  - conditional+gzip cuts bytes-on-wire >= 10x vs naive polling;
  - p99 /report.json <= 50 ms under the loaded scan;
  - scan wall-clock interference <= 5%.

Box caveat: on a 1-core container the poller fleet, the HTTP server
threads, the broker child, and the fold all share the core — poller
throughput UNDERSTATES a real host and interference OVERSTATES it.  The
JSON records achieved rates so the window is honest about what it ran.
"""

from __future__ import annotations

import argparse
import gzip as _gzip
import http.client
import json
import os
import sys
import threading
import time


# ---------------------------------------------------------------------------
# a realistic report body


def make_report_doc(topics: int = 24) -> dict:
    """A fleet-rollup-shaped document: per-topic metric blocks at the
    field fan-out a real scan publishes (sizes match a ~24-topic fleet;
    the JSON records the exact byte count actually served)."""
    def topic_block(i: int) -> dict:
        return {
            "topic": f"fleet.topic.{i:03d}",
            "status": "ok",
            "passes": 3 + i % 5,
            "metrics": {
                "count": 1_000_000 + i * 7919,
                "tombstones": 12_345 + i,
                "alive_keys": 404_040 + i * 31,
                "key_cardinality_hll": 398_872 + i * 29,
                "largest_message": 1_048_576 - i,
                "earliest_ts": 1_600_000_000_000 + i,
                "latest_ts": 1_700_000_000_000 + i,
                "key_size": {"p50": 18, "p90": 42, "p99": 64, "sum": 18_000_000 + i},
                "value_size": {"p50": 256, "p90": 1024, "p99": 4096, "sum": 256_000_000 + i},
                "partitions": {
                    str(p): {
                        "count": 62_500 + p * 13 + i,
                        "start_offset": 0,
                        "end_offset": 62_500 + p * 13 + i,
                        "tombstones": 771 + p,
                        "alive_keys": 25_252 + p,
                    }
                    for p in range(16)
                },
            },
        }
    return {
        "mode": "fleet-rollup",
        "instance": "bench",
        "topics": {b["topic"]: b for b in map(topic_block, range(topics))},
        "degraded": [],
        "corrupt": [],
    }


# ---------------------------------------------------------------------------
# the poller fleet


class Poller(threading.Thread):
    """One dashboard: a persistent keep-alive connection polling
    /report.json at ``hz``, optionally with the conditional+gzip
    contract.  Falls behind rather than bursting — missed ticks are
    counted, not replayed (a real 1 Hz dashboard drops frames too)."""

    def __init__(self, port: int, hz: float, t_end: float,
                 conditional: bool, phase: float):
        super().__init__(daemon=True)
        self.port = port
        self.hz = hz
        self.t_end = t_end
        self.conditional = conditional
        self.phase = phase
        self.lat_ms: "list[float]" = []
        self.body_bytes = 0
        self.polls = 0
        self.not_modified = 0
        self.gzip_bodies = 0
        self.errors = 0
        self.missed_ticks = 0

    def run(self) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=15)
        etag = None
        period = 1.0 / self.hz
        next_tick = time.monotonic() + self.phase
        while True:
            now = time.monotonic()
            if now >= self.t_end:
                break
            if now < next_tick:
                time.sleep(min(next_tick - now, self.t_end - now))
                continue
            behind = int((now - next_tick) / period)
            if behind > 0:
                self.missed_ticks += behind
            next_tick += period * (behind + 1)
            hdrs = {}
            if self.conditional:
                hdrs["Accept-Encoding"] = "gzip"
                if etag:
                    hdrs["If-None-Match"] = etag
            t0 = time.perf_counter()
            try:
                conn.request("GET", "/report.json", headers=hdrs)
                resp = conn.getresponse()
                body = resp.read()
            except (OSError, http.client.HTTPException):
                self.errors += 1
                conn.close()
                conn = http.client.HTTPConnection(
                    "127.0.0.1", self.port, timeout=15)
                continue
            self.lat_ms.append((time.perf_counter() - t0) * 1e3)
            self.polls += 1
            self.body_bytes += len(body)
            if resp.status == 200:
                etag = resp.headers.get("ETag")
                if resp.headers.get("Content-Encoding") == "gzip":
                    self.gzip_bodies += 1
            elif resp.status == 304:
                self.not_modified += 1
            elif resp.status not in (404, 503):
                self.errors += 1
        conn.close()


class SseListener(threading.Thread):
    """One push client: counts frames until the deadline."""

    def __init__(self, port: int, t_end: float):
        super().__init__(daemon=True)
        self.port = port
        self.t_end = t_end
        self.frames = 0

    def run(self) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=20)
        try:
            conn.request("GET", "/events")
            resp = conn.getresponse()
            while time.monotonic() < self.t_end:
                line = resp.fp.readline()
                if not line:
                    break
                if line.startswith(b"event:"):
                    self.frames += 1
        except (OSError, http.client.HTTPException):
            pass
        finally:
            conn.close()


def _pct(sorted_ms: "list[float]", q: float) -> float:
    if not sorted_ms:
        return 0.0
    return sorted_ms[min(len(sorted_ms) - 1, int(len(sorted_ms) * q))]


def run_fleet(port: int, n: int, hz: float, seconds: float,
              conditional: bool, sse: int = 0,
              stop: "threading.Event | None" = None) -> dict:
    """N pollers (and ``sse`` listeners) for ``seconds``, or until
    ``stop`` is set if that comes first; ``seconds`` in the result is
    then the time to the stop (polls in flight at the stop still
    finish and count)."""
    t0 = time.monotonic()
    t_end = t0 + seconds
    pollers = [
        Poller(port, hz, t_end, conditional, phase=(i / n) / hz)
        for i in range(n)
    ]
    listeners = [SseListener(port, t_end) for _ in range(sse)]
    for t in pollers + listeners:
        t.start()
    if stop is not None and stop.wait(seconds):
        cut = time.monotonic()
        for t in pollers + listeners:
            t.t_end = min(t.t_end, cut)
        seconds = cut - t0
    for t in pollers:
        t.join(seconds + 30)
    lat = sorted(x for p in pollers for x in p.lat_ms)
    polls = sum(p.polls for p in pollers)
    out = {
        "pollers": n,
        "hz": hz,
        "seconds": seconds,
        "conditional_gzip": conditional,
        "polls": polls,
        "achieved_hz_per_poller": round(polls / max(seconds, 1e-9) / n, 3),
        "missed_ticks": sum(p.missed_ticks for p in pollers),
        "errors": sum(p.errors for p in pollers),
        "not_modified": sum(p.not_modified for p in pollers),
        "gzip_bodies": sum(p.gzip_bodies for p in pollers),
        "body_bytes_total": sum(p.body_bytes for p in pollers),
        "bytes_per_poll": round(
            sum(p.body_bytes for p in pollers) / max(polls, 1), 1),
        "lat_p50_ms": round(_pct(lat, 0.50), 2),
        "lat_p99_ms": round(_pct(lat, 0.99), 2),
        "lat_max_ms": round(_pct(lat, 1.0), 2),
    }
    if sse:
        out["sse_listeners"] = sse
        out["sse_frames"] = sum(ls.frames for ls in listeners)
    return out


# ---------------------------------------------------------------------------
# arm 1+2: the byte-cut referee (static publisher, republish cadence)


def bench_poll(n: int, hz: float, seconds: float, republish_s: float) -> dict:
    from kafka_topic_analyzer_tpu_torch.obs.exporters import PrometheusExporter
    from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
    from kafka_topic_analyzer_tpu_torch.serve import push as serve_push
    from kafka_topic_analyzer_tpu_torch.serve import state as serve_state
    from kafka_topic_analyzer_tpu_torch.serve.push import SsePublisher
    from kafka_topic_analyzer_tpu_torch.serve.state import ServiceState

    doc = make_report_doc()
    raw = json.dumps(doc).encode()
    arms = {}
    for conditional in (False, True):
        default_registry().reset()
        svc = ServiceState()
        serve_state.set_active(svc)
        pub = SsePublisher().start()
        serve_push.set_active(pub)
        svc.publish(dict(doc), summary={"records": 1})
        exporter = PrometheusExporter(0)
        stop = threading.Event()

        def republisher():
            i = 2
            while not stop.wait(republish_s):
                d = dict(doc)
                d["pass"] = i  # content actually changes each publish
                svc.publish(d, summary={"records": i})
                i += 1

        rt = threading.Thread(target=republisher, daemon=True)
        rt.start()
        try:
            arms["conditional" if conditional else "naive"] = run_fleet(
                exporter.port, n, hz, seconds, conditional)
        finally:
            stop.set()
            rt.join(5)
            pub.stop()
            exporter.close()
            serve_push.set_active(None)
            serve_state.set_active(None)
    naive, cond = arms["naive"], arms["conditional"]
    ratio = (
        naive["bytes_per_poll"] / cond["bytes_per_poll"]
        if cond["bytes_per_poll"] else float("inf")
    )
    return {
        "report_identity_bytes": len(raw),
        "report_gzip_bytes": len(_gzip.compress(raw, 6)),
        "republish_every_s": republish_s,
        "naive": naive,
        "conditional": cond,
        "bytes_per_poll_cut": round(ratio, 1),
    }


# ---------------------------------------------------------------------------
# arm 3+4: the interference referee (real follow scan on a template broker)


#: The scan arms' topic: 4 partitions × 12 windows of 1,000 records.
SCAN_TOPIC = dict(topic="bench.serve", partitions=4, windows=12, R=1000,
                  n_templates=8, vmin=64, vmax=192, compression=0,
                  tombstone_every=7)


def _scan_once(port: int, serving: "dict | None", device: str) -> dict:
    """One follow scan to drain + idle-exit; returns wall seconds and
    (when serving) the fleet's client-side view measured DURING it."""
    from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
    from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig, FollowConfig
    from kafka_topic_analyzer_tpu_torch.io.kafka_wire import KafkaWireSource
    from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
    from kafka_topic_analyzer_tpu_torch.serve.follow import FollowService

    default_registry().reset()
    n_parts = SCAN_TOPIC["partitions"]
    cfg = AnalyzerConfig(
        num_partitions=n_parts, batch_size=256,
        count_alive_keys=True, alive_bitmap_bits=18,
        enable_hll=True, hll_p=12,
    )
    follow = FollowConfig(
        poll_interval_s=0.02, idle_backoff_max_s=0.05, idle_exit_s=0.5,
    )
    fleet_stats = None
    src = KafkaWireSource(
        f"127.0.0.1:{port}", SCAN_TOPIC["topic"],
        overrides={"retry.backoff.ms": "5"},
    )
    svc = FollowService(
        SCAN_TOPIC["topic"], src,
        TorchBackend(cfg, init_now_s=10**10, device=device), 256, follow,
    )
    t0 = time.perf_counter()
    if serving is None:
        result = svc.run()
        wall = time.perf_counter() - t0
    else:
        fleet_box = {}

        def fleet():
            fleet_box["stats"] = run_fleet(
                serving["port"], serving["pollers"], serving["hz"],
                serving["seconds"], conditional=True,
                sse=serving["sse"],
            )

        ft = threading.Thread(target=fleet, daemon=True)
        ft.start()
        result = svc.run()
        wall = time.perf_counter() - t0
        ft.join(serving["seconds"] + 60)
        fleet_stats = fleet_box.get("stats")
    src.close()
    count = result.metrics.to_dict(
        result.start_offsets, result.end_offsets
    )["overall"]["count"]
    out = {"wall_s": round(wall, 3), "records_folded": int(count)}
    if fleet_stats is not None:
        out["fleet"] = fleet_stats
    return out


def bench_scan(n_pollers: int, hz: float, device: str) -> dict:
    """The interference referee over one template-broker child."""
    from kafka_topic_analyzer_tpu_torch.tools.bench_e2e import BrokerProcess

    broker = BrokerProcess(**SCAN_TOPIC)
    port = broker.__enter__()
    try:
        return _bench_scan(port, n_pollers, hz, device)
    finally:
        broker.__exit__(None, None, None)


def _bench_scan(port: int, n_pollers: int, hz: float, device: str) -> dict:
    from kafka_topic_analyzer_tpu_torch.obs.exporters import PrometheusExporter
    from kafka_topic_analyzer_tpu_torch.serve import push as serve_push
    from kafka_topic_analyzer_tpu_torch.serve.push import SsePublisher

    # Best-of-3 bare: the interference denominator must not be a noisy
    # single sample on a shared core.
    bare_runs = [_scan_once(port, None, device) for _ in range(3)]
    bare = min(bare_runs, key=lambda r: r["wall_s"])
    bare["wall_s_runs"] = [r["wall_s"] for r in bare_runs]
    # Size the poller window to the bare wall so the fleet hammers the
    # scan for its WHOLE duration (plus the drain tail).
    window = max(6.0, bare["wall_s"] * 1.5)

    pub = SsePublisher().start()
    serve_push.set_active(pub)
    exporter = PrometheusExporter(0)
    try:
        loaded = _scan_once(port, serving={
            "port": exporter.port, "pollers": n_pollers, "hz": hz,
            "seconds": window, "sse": 8,
        }, device=device)
    finally:
        pub.stop()
        exporter.close()
        serve_push.set_active(None)
    assert loaded["records_folded"] == bare["records_folded"]
    interference = loaded["wall_s"] / bare["wall_s"] - 1.0
    return {
        "records": SCAN_TOPIC["partitions"] * SCAN_TOPIC["windows"] * SCAN_TOPIC["R"],
        "partitions": SCAN_TOPIC["partitions"],
        "bare": bare,
        "loaded": loaded,
        "interference_pct": round(interference * 100.0, 1),
    }


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pollers", type=int, default=1000,
                    help="concurrent dashboard connections (default 1000)")
    ap.add_argument("--hz", type=float, default=1.0,
                    help="poll rate per dashboard (default 1 Hz)")
    ap.add_argument("--seconds", type=float, default=12.0,
                    help="duration of each static poll arm")
    ap.add_argument("--republish", type=float, default=2.0,
                    help="report republish cadence in the poll arms")
    ap.add_argument("--scan-pollers", type=int, default=None,
                    help="poller count during the scan arms "
                         "(default: same as --pollers)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the follow scans' torch backend runs "
                         "(default: the first CUDA device)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON document to this file")
    args = ap.parse_args(argv)

    t0 = time.time()
    print(f"== poll arms: {args.pollers} pollers @ {args.hz} Hz, "
          f"{args.seconds}s each, republish every {args.republish}s",
          flush=True)
    poll = bench_poll(args.pollers, args.hz, args.seconds, args.republish)
    print(json.dumps({k: poll[k] for k in
                      ("report_identity_bytes", "bytes_per_poll_cut")}),
          flush=True)
    scan_pollers = args.scan_pollers or args.pollers
    print(f"== scan arms: follow scan bare vs {scan_pollers} "
          f"conditional pollers + 8 SSE listeners", flush=True)
    scan = bench_scan(scan_pollers, args.hz, args.device)
    print(json.dumps({"interference_pct": scan["interference_pct"],
                      "p99_ms": scan["loaded"]["fleet"]["lat_p99_ms"]
                      if scan["loaded"].get("fleet") else None}),
          flush=True)
    scan_moderate = None
    if scan_pollers > 100:
        # Attribution arm: the same referee at a fleet a shared core can
        # actually schedule — shows whether a miss above is the design
        # or the box.
        print("== scan arms (attribution): 100-poller fleet", flush=True)
        scan_moderate = bench_scan(100, args.hz, args.device)
        print(json.dumps(
            {"interference_pct": scan_moderate["interference_pct"],
             "p99_ms": scan_moderate["loaded"]["fleet"]["lat_p99_ms"]}),
            flush=True)

    bars = {
        "bytes_cut_10x": {
            "bar": ">= 10x bytes-per-poll cut, conditional+gzip vs naive",
            "measured": poll["bytes_per_poll_cut"],
            "met": poll["bytes_per_poll_cut"] >= 10.0,
        },
        "p99_under_scan_50ms": {
            "bar": "p99 /report.json <= 50 ms while the scan folds",
            "measured": (scan["loaded"].get("fleet") or {}).get("lat_p99_ms"),
            "met": bool(scan["loaded"].get("fleet"))
            and scan["loaded"]["fleet"]["lat_p99_ms"] <= 50.0,
        },
        "interference_5pct": {
            "bar": "scan wall-clock interference <= 5% with the plane on",
            "measured": scan["interference_pct"],
            "met": scan["interference_pct"] <= 5.0,
        },
    }
    doc = {
        "bench": "serve",
        "device": args.device,
        "host": {"nproc": os.cpu_count(),
                 "note": "poller fleet, server threads, broker child and "
                         "fold share these cores; 1-core containers "
                         "understate throughput and overstate "
                         "interference"},
        "wall_s": round(time.time() - t0, 1),
        "poll": poll,
        "scan": scan,
        "scan_100_pollers": scan_moderate,
        "bars": bars,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}")
    for name, b in bars.items():
        print(f"  {'MET ' if b['met'] else 'MISS'} {name}: "
              f"{b['measured']} ({b['bar']})")
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
