"""Traffic ``follow``: the program as a service (``--follow``, its default
1.0 s poll interval) on a topic whose head moves at a fixed rate.

Set-up starts the broker with the configuration's topic visible as a
backlog, starts the service in this process (``cli.main`` with
``--follow --metrics-port <port> --sse --json``) and the load process
(`benchmark.gen.load`: producer and SSE client), and ends when a frame
covers the backlog. In the window the producer raises every partition's
head by one window per step, open loop, ``rate`` records per second in
all; after it the client waits until a frame covers the last step, and
the service is stopped with SIGTERM, after which the CLI prints its final
document.

A step's staleness is the time from its stamp at the producer to the
arrival of the first frame whose document covers it (its ``records``
reach the step's total). ``staleness_p50_s`` and ``staleness_p95_s``
are taken over every step of the window; a step no frame covers within
``settle_s`` counts as failed, its staleness the wait until then. The last document the client fetched in the
window and the final document are both judged. Parameters in the cell's
file: ``rate`` (records/s), ``settle_s``.
"""

from __future__ import annotations

import contextlib
import io
import json
import multiprocessing
import os
import signal
import socket
import threading
import time

from benchmark import probes
from benchmark.gen.broker import BrokerProcess
from benchmark.gen.load import load_main
from benchmark.gen.topic import Topic


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def heads_of(doc: dict, R: int, P: int) -> "list[int]":
    """Windows per partition a follow document covers, from its cursor."""
    nxt = doc["follow"]["next_offsets"]
    offs = [int(nxt.get(str(p), 0)) for p in range(P)]
    if any(o % R for o in offs):
        raise ValueError(f"a cursor lies inside a batch: {offs}")
    return [o // R for o in offs]


def run(ctx) -> dict:
    t = ctx.config["topic"]
    P, R = t["partitions"], t["records_per_batch"]
    backlog = t["records_per_partition"] // R
    per_step = P * R
    steps_per_s = float(ctx.params["rate"]) / per_step
    settle_s = float(ctx.params["settle_s"])
    max_windows = backlog + int(steps_per_s * ctx.seconds) + 2
    topic_name = "bench-" + ctx.config["name"]
    port = _free_port()
    state: dict = {}
    with BrokerProcess(ctx.config, ctx.seed, topic_name, max_windows, head=backlog) as broker:
        ctx.init_device()  # while the broker builds its templates
        from kafka_topic_analyzer_tpu_torch import cli

        broker.wait_ready()
        ctx.log(f"broker up at {time.monotonic() - ctx.t_start:.3f} s")
        spawn = multiprocessing.get_context("spawn")
        parent, child = spawn.Pipe()
        load = spawn.Process(target=load_main, daemon=True, args=(
            child, broker.head_conn, port, per_step, backlog, steps_per_s,
            ctx.seconds, settle_s))
        load.start()
        child.close()

        def control() -> None:
            # Runs beside the service: opens and closes the window, then
            # asks the service to stop as an operator's SIGTERM does.
            try:
                while True:
                    kind, body = parent.recv()
                    if kind == "open":
                        state["setup_s"] = body - ctx.t_start
                        state["before"] = probes.counters()
                    elif kind == "done":
                        state["after"] = probes.counters()
                        state["load"] = body
                        break
                    else:
                        state["error"] = body
                        break
            except EOFError:
                state["error"] = "the load process ended early"
            if state.get("serving", True):
                os.kill(os.getpid(), signal.SIGTERM)

        ctl = threading.Thread(target=control, daemon=True)
        ctl.start()
        argv = ["-t", topic_name, "-b", broker.bootstrap, "--json", "--quiet",
                "--follow", "--metrics-port", str(port), "--sse", *ctx.argv]
        out = io.StringIO()
        with probes.DeviceTrace(ctx.trace, ctx.tmpdir, ctx.cuda) as trace:
            with contextlib.redirect_stdout(out):
                try:
                    rc = cli.main(argv)
                finally:
                    state["serving"] = False
        ctx.synchronize()
        ctl.join(30)
        load.join(30)
        if load.is_alive():
            load.terminate()
            load.join(5)
    if "error" in state or "load" not in state:
        raise RuntimeError(f"follow: {state.get('error', 'no window')} (exit {rc})")
    lines = out.getvalue().strip().splitlines()
    final = json.loads(lines[-1]) if rc == 0 and lines else None
    ld = state["load"]
    t0, t1 = ld["t_open"], ld["t_close"]
    frames = ld["frames"]
    stale, failed = [], 0
    i = 0
    for k, stamp in enumerate(ld["stamps"], start=1):
        need = (backlog + k) * per_step
        while i < len(frames) and frames[i][2].get("records", 0) < need:
            i += 1
        if i < len(frames):
            stale.append(frames[i][0] - stamp)
        else:  # never covered: it waited at least until the client gave up
            stale.append(ld["t_done"] - stamp)
            failed += 1
    topic = Topic(ctx.config, ctx.seed, name=topic_name)
    judge = []
    for doc in (ld["window_doc"], final):
        heads = heads_of(doc, R, P) if doc is not None else [backlog] * P
        judge.append((topic, heads, [doc]))
    passes = sum(1 for m, _, _ in frames if t0 <= m <= t1)
    ctx.log(f"follow: {len(ld['stamps'])} steps, {passes} frames in the window")
    metrics = {"staleness_p50_s": probes.nearest_rank(stale, 0.5),
               "staleness_p95_s": probes.nearest_rank(stale, 0.95)}
    return {
        "setup_s": state["setup_s"],
        "metrics": metrics,
        "attempted": len(ld["stamps"]),
        "failed": failed,
        "judge": judge,
        "layer": {
            "counters": probes.delta(state["before"], state["after"]),
            "frames": [(w, d) for m, w, d in frames if t0 <= m <= t1],
            "device": trace.summary(t0, t1) if ctx.trace else None,
        },
        "stamps": ld["stamps"],
        "frames": frames,
        "backlog": backlog,
        "per_step": per_step,
        "broker_cpu_s": broker.cpu_s,
    }
