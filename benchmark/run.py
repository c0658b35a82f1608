#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration (its
file under ``benchmark/configs/``) and a traffic kind, whose driver is
``benchmark/traffic/<kind>.py``; the cell's own parameters and the limits
of its correctness numbers are in ``benchmark/workloads/<cell>.json``.
With ``--trace 0`` the result carries the cell's end-to-end metrics (the
driver's, ``setup_s``, and ``device_memory_peak_bytes``: the most device
memory allocated from set-up's start to the window's close), with
``--trace 1`` its per-layer metrics, each read by
``benchmark/metrics/<metric>.py`` from the traced run.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` and, traced,
``breakdown``, then ``checks``: each number compared with the reference,
beside its limit, which also end standard error. Without a CUDA device,
or with fewer than the cell asks for, the run fails and prints no result.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Top-level modules that may not be loaded in a run: the JAX stack and
#: the JAX package the program was ported from. Compared as whole names.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "kafka_topic_analyzer_tpu")
#: A device operation's name in ``breakdown``, cut to this length (CUDA's
#: template names run to a thousand characters).
OP_NAME_CHARS = 160


class NoDevice(RuntimeError):
    """The cell asks for more CUDA devices than are visible."""


class Run:
    """What a traffic driver gets: the cell, its configuration, the run's
    arguments, a scratch directory under ``TMPDIR``, and the program's
    CLI arguments for the configuration."""

    def __init__(self, args, cell: dict, config: dict, params: dict,
                 tmpdir: str, cuda: bool, extra_argv: "list[str]"):
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.cell = cell
        self.config = config
        self.params = params
        self.tmpdir = tmpdir
        self.cuda = cuda
        self.t_start = T_START
        self.argv = list(config["argv"]) + list(extra_argv)

    def init_device(self) -> None:
        """Start CUDA (drivers call this while their broker builds) and
        check that the cell's devices are there."""
        import torch

        if not self.cuda:
            return
        chips = self.cell["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise NoDevice(f"the cell needs {chips} CUDA device(s); {seen} visible")
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()

    def log(self, msg: str) -> None:
        print(f"bench: {msg}", file=sys.stderr, flush=True)

    def synchronize(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()


def forbidden_modules(names) -> "list[str]":
    """The forbidden top-level names among ``names`` (``sys.modules``
    keys), each compared whole: ``kafka_topic_analyzer_tpu_torch`` is not
    ``kafka_topic_analyzer_tpu``."""
    top = {n.split(".", 1)[0] for n in names}
    return sorted(top.intersection(FORBIDDEN_MODULES))


def load_reader(name: str):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def main(argv=None, *, manifest: "Path | None" = None, cpu: bool = False) -> int:
    """``manifest`` and ``cpu`` serve the harness's own tests: another
    manifest (cells and configurations beside it), and the program on the
    host (``--device cpu``) without the look for a CUDA device."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = manifest or ROOT / "BENCHMARK.json"
    base = manifest.parent
    bench = json.loads(manifest.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"error: no cell {args.workload!r} in {manifest.name}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    conf_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((base / conf_entry["file"]).read_text())
    params = json.loads((base / "benchmark" / "workloads" / f"{cell['name']}.json").read_text())

    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    tmpdir = tempfile.mkdtemp(prefix="bench-")
    try:
        ctx = Run(args, cell, config, params, tmpdir, not cpu,
                  ["--device", "cpu"] if cpu else [])
        driver = importlib.import_module(f"benchmark.traffic.{cell['traffic']}")
        try:
            out = driver.run(ctx)
        except NoDevice as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        import torch

        peak = torch.cuda.max_memory_allocated() if not cpu else 0
        return report(bench, cell, params, ctx, out, peak, cpu)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def report(bench: dict, cell: dict, params: dict, ctx: Run, out: dict,
           peak: int, cpu: bool) -> int:
    from benchmark.reference.compare import compare, verdict, worst
    from benchmark.reference.report import reference_report

    readings = []
    for topic, heads, docs in out["judge"]:
        ref = reference_report(topic, heads, ctx.argv)
        for doc in docs:
            if doc is None:
                readings.append({"documents_missing": 1})
            else:
                readings.append(dict(compare(doc, ref), documents_missing=0))
    numbers = worst(readings) if readings else {"documents_missing": 1}
    limits = dict(params["limits"], documents_missing=0)
    correct = verdict(numbers, limits) and out["failed"] == 0

    name = cell["name"]
    metrics = {}
    breakdown = None
    if not ctx.trace:
        want = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        values = dict(out["metrics"], setup_s=out["setup_s"],
                      device_memory_peak_bytes=int(peak))
        for m in want:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        layer = out["layer"]
        for m in bench["per_layer"]:
            if name not in m.get("workloads", [name]):
                continue
            value = load_reader(m["name"])(layer, ctx.config)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = layer["device"]
        ops = sorted(dev["ops"].items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(dev["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
        breakdown = {"device_ops": [[n[:OP_NAME_CHARS], s] for n, (s, _) in ops],
                     "idle_gaps": [[n, s] for n, s in gaps]}

    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"error: forbidden modules loaded in this run: {', '.join(found)}",
              file=sys.stderr)
        return 3

    import torch

    device = {
        "platform": "cpu" if cpu else "gpu",
        "kind": "cpu" if cpu else torch.cuda.get_device_name(0),
        "count": cell["chips"],
        "memory_peak_bytes": int(peak),
    }
    if ctx.trace:
        device["busy_s"] = out["layer"]["device"]["busy_s"]
        device["window_s"] = out["layer"]["device"]["window_s"]
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in sorted(numbers.items())}
    if out.get("broker_cpu_s") is not None:
        print(f"broker cpu_s {out['broker_cpu_s']:.3f}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


def _finite(v):
    """JSON has no infinity: a number that never came is reported as null."""
    return None if isinstance(v, float) and not math.isfinite(v) else v


if __name__ == "__main__":
    sys.exit(main())
