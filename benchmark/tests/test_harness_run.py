"""Whole runs of every cell on the host at a tiny size (``--device cpu``,
the look for a CUDA device skipped): correct as the program stands,
incorrect with the timed path broken underneath, and the controls
rejected."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark import control, run

CELLS = ["demo-compacted.audit", "omb-16p-1kb.audit", "demo-compacted.follow"]


def one_run(manifest, cell, capsys, trace=0, seconds=2.0):
    rc = run.main(["--workload", cell, "--seed", str(2**31 + 77), "--seconds",
                   str(seconds), "--trace", str(trace)], manifest=manifest, cpu=True)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    result = json.loads(out.out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert out.err.strip().splitlines()[-1].startswith("check ")
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(manifest, cell, capsys):
    result = one_run(manifest, cell, capsys)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"setup_s", "device_memory_peak_bytes"} <= set(result["metrics"])
    assert len(result["metrics"]) == (2 if "audit" in cell else 4)


@pytest.mark.parametrize("cell", ["demo-compacted.audit", "demo-compacted.follow"])
def test_traced_run_reads_the_counters(manifest, cell, capsys):
    result = one_run(manifest, cell, capsys, trace=1)
    assert result["correct"]
    assert "busy_s" in result["device"] and "window_s" in result["device"]
    assert {"device_ops", "idle_gaps"} <= set(result["breakdown"])
    names = set(result["metrics"])
    if cell.endswith("audit"):
        # The host has no device timeline: those readers find nothing.
        assert {"audit_records_per_s.scan", "ingest_busy_share.scan", "dispatch_share.scan",
                "finalize_s.scan"} <= names
        assert "counters_merge_roofline.scan" not in names
    else:
        assert {"finalize_s.follow", "delivery_ms_p95.follow"} <= names


def _unchanged(monkeypatch):
    from kafka_topic_analyzer_tpu_torch.backends import gpu

    monkeypatch.setattr(gpu, "analyzer_step", lambda *a, **k: None)
    monkeypatch.setattr(gpu, "apply_pair_table", lambda *a, **k: None)


def _half(monkeypatch):
    from kafka_topic_analyzer_tpu_torch.backends import gpu

    update = gpu.TorchBackend.update
    seen = {"n": 0}

    def every_other(self, batch):
        seen["n"] += 1
        if seen["n"] % 2:
            update(self, batch)

    monkeypatch.setattr(gpu.TorchBackend, "update", every_other)


def _altered(monkeypatch):
    from kafka_topic_analyzer_tpu_torch.backends import gpu

    produce = gpu.metrics_from_state

    def off_by_one(*a, **k):
        m = produce(*a, **k)
        m.per_partition = m.per_partition.copy()
        m.per_partition[0, 0] += 1
        return m

    monkeypatch.setattr(gpu, "metrics_from_state", off_by_one)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state-unchanged", "half-the-batches", "answer-altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_incorrect(manifest, cell, fault, monkeypatch, capsys):
    fault(monkeypatch)
    result = one_run(manifest, cell, capsys)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_32bit_reference_is_rejected(manifest, cell, capsys):
    control.main(["--workload", cell, "--seeds", "1,2,3", "--steps", "5"], manifest=manifest)
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 3 and all(x["rejected"] for x in lines)


def test_program_with_half_the_alive_slots_is_rejected(manifest, capsys):
    control.main(["--workload", "demo-compacted.audit", "--seeds", "5", "--program"],
                 manifest=manifest, cpu=True)
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    prog = [x for x in lines if x["control"] == "alive-bitmap-bits-31"]
    assert prog and prog[0]["rejected"] and prog[0]["numbers"]["alive_keys_gap"] > 0


def test_forbidden_modules_compare_whole_names():
    assert run.forbidden_modules(["kafka_topic_analyzer_tpu_torch.cli", "numpy"]) == []
    assert run.forbidden_modules(["kafka_topic_analyzer_tpu.cli"]) == ["kafka_topic_analyzer_tpu"]
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "jaxtyping", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def test_no_card_no_result(manifest, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                  manifest=manifest)
    assert rc != 0 and capsys.readouterr().out == ""


def test_lowp_is_the_only_difference(manifest):
    """The 32-bit control differs from the reference only by its types."""
    from benchmark.gen.topic import Topic
    from benchmark.reference.report import reference_report

    _, config, _ = control.cell_files("demo-compacted.audit", manifest)
    topic = Topic(config, 3)
    heads = np.full(topic.P, topic.windows)
    ref = reference_report(topic, heads, config["argv"])
    low = reference_report(topic, heads, config["argv"], lowp=True)
    assert ref["alive_keys"] == low["alive_keys"]
    assert ref["partitions"]["0"]["total"] == low["partitions"]["0"]["total"]
