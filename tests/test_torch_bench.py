"""The port's benchmark tools against the reference's: the five BASELINE
configs of ``tools/bench.py`` (the repo-root ``bench.py``'s), its sketch
errors on the same records (equal, not close: same records, same
sketches), the refusal to run without a card unless ``--device cpu``,
``hwmeasure.timed_step_loop``'s state leaf for leaf, ``bench_all``'s
children and report, and ``RecordBatch.pad_to``."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from kafka_topic_analyzer_tpu import packing as ref_packing
from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefConfig
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSource as RefSource
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSpec as RefSpec
from kafka_topic_analyzer_tpu.records import RecordBatch as RefBatch
from kafka_topic_analyzer_tpu.tools import hwmeasure as ref_hwmeasure
from kafka_topic_analyzer_tpu_torch import packing
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.models.state import state_to_numpy
from kafka_topic_analyzer_tpu_torch.records import RecordBatch
from kafka_topic_analyzer_tpu_torch.tools import bench, bench_all, hwmeasure

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_reference_bench():
    """The repo-root ``bench.py`` as a module (it imports only the standard
    library at module level)."""
    spec = importlib.util.spec_from_file_location(
        "reference_root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_configs_are_the_reference_benchs():
    ref = load_reference_bench()
    assert bench.CONFIGS == ref.CONFIGS
    assert bench.BASELINE_MSGS_PER_SEC == ref.BASELINE_MSGS_PER_SEC


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def reference_bench(args) -> dict:
    env = dict(os.environ, KTA_BENCH_CHILD="1", KTA_ACCEL_OK="1",
               JAX_PLATFORMS="cpu")
    env.pop("KTA_JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, os.path.join(REPO, "bench.py"), *args],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return last_json(proc.stdout)


SMALL = ["--batch-size", "4096", "--batches", "3", "--steps", "3",
         "--accuracy", "--accuracy-seeds", "2"]
ACCURACY_KEYS = ("hll_rel_error", "quantile_rel_error_max", "hll_rel_error_seeds",
                 "hll_rel_error_mean", "hll_rel_error_max",
                 "quantile_rel_error_seeds_max", "accuracy_seed_batches",
                 "accuracy_seed_records")


@pytest.mark.parametrize("flags", [
    ["--config", "2"], ["--config", "3"], ["--config", "4"], ["--config", "5"],
    ["--config", "3", "--wire-format", "v4", "--pallas"],
], ids=["config2", "config3", "config4", "config5", "config3-v4-pallas"])
def test_sketch_errors_equal_the_reference_bench(flags, capsys):
    assert bench.main(flags + SMALL + ["--device", "cpu"]) == 0
    got = last_json(capsys.readouterr().out)
    want = reference_bench(flags + SMALL)
    present = [k for k in ACCURACY_KEYS if k in want]
    assert "accuracy_seed_records" in present
    assert "hll_rel_error" in present or "quantile_rel_error_max" in present
    assert {k: got.get(k) for k in ACCURACY_KEYS} == {k: want.get(k) for k in ACCURACY_KEYS}
    assert got["platform"] == "cpu" and got["device"] == "cpu"
    assert got["batch_size"] == want["batch_size"] == 4096
    assert got["value"] > 0 and got["metric"] == "msgs_per_sec"
    # The breakdown describes a card: absent on the host, as the
    # reference's is.
    assert "transfer_gbps" not in got and "breakdown_error" not in got


def test_bench_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "kafka_topic_analyzer_tpu_torch.tools.bench",
         "--config", "1", "--batch-size", "4096", "--batches", "1", "--steps", "1"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode != 0
    assert not [line for line in proc.stdout.splitlines() if line.startswith("{")]
    assert "CUDA device requested" in proc.stderr


def test_transfer_measurement_refuses_the_host():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        hwmeasure.measure_transfer_gbps("cpu", (1,))


def jax_leaves(state) -> "dict[str, np.ndarray]":
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(state))
    return {jax.tree_util.keystr(path).lstrip("."): np.array(leaf)
            for path, leaf in flat}


STEP_CASES = {
    "v5": dict(),
    "v4": dict(wire_format=4),
    "v5-compaction-off": dict(alive_compaction="off"),
}


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "streamed"])
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_timed_step_loop_leaves_the_reference_state(case, resident):
    kw = dict(num_partitions=3, batch_size=1024, count_alive_keys=True,
              alive_bitmap_bits=18, enable_hll=True, hll_p=10,
              enable_quantiles=True, use_pallas_counters=True, **STEP_CASES[case])
    ref_cfg, cfg = RefConfig(**kw), AnalyzerConfig(**kw)
    spec = RefSpec(num_partitions=3, messages_per_partition=900,
                   keys_per_partition=60, tombstone_permille=300, seed=3)
    batches = [b.pad_to(1024) for b in RefSource(spec).batches(1024)]
    ref_rows = [ref_packing.pack_batch(b, ref_cfg, use_native=False) for b in batches]
    rows = [packing.pack_batch(RecordBatch(**b.as_dict()), cfg) for b in batches]
    for ours, theirs in zip(rows, ref_rows):
        np.testing.assert_array_equal(ours, theirs)
    ref_feed = [jax.device_put(r) for r in ref_rows] if resident else ref_rows
    feed = [torch.from_numpy(r) for r in rows] if resident else rows
    want = ref_hwmeasure.timed_step_loop(ref_cfg, ref_feed, steps=4,
                                         device_resident=resident)
    got = hwmeasure.timed_step_loop(cfg, feed, steps=4, device_resident=resident,
                                    device="cpu")
    assert got["msgs_per_sec"] > 0 and got["compile_s"] >= 0
    ours, theirs = state_to_numpy(got["state"]), jax_leaves(want["state"])
    assert sorted(ours) == sorted(theirs)
    for name in theirs:
        assert ours[name].dtype == theirs[name].dtype, name
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)


class _Done:
    def __init__(self, returncode, stdout="", stderr=""):
        self.returncode, self.stdout, self.stderr = returncode, stdout, stderr


def test_bench_all_runs_the_ports_children_and_maps_their_lines(monkeypatch, capsys):
    calls = []

    def fake_run(cmd, **kw):
        calls.append((cmd, kw))
        if cmd[2].endswith("bench_e2e"):
            return _Done(0, "noise\n" + json.dumps({"metric": "e2e_msgs_per_sec"}) + "\n")
        cfg = int(cmd[cmd.index("--config") + 1])
        if cfg == 2:
            return _Done(1, "", "Traceback...\nRuntimeError: no card")
        return _Done(0, "bench: x\n" + json.dumps({"value": cfg}) + "\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert bench_all.main(["--configs", "1,2", "--device", "cpu",
                           "--batch-size", "4096"]) == 0
    report = last_json(capsys.readouterr().out)
    assert report == {"1": {"value": 1},
                      "2": {"error": "Traceback...\nRuntimeError: no card"},
                      "e2e": {"metric": "e2e_msgs_per_sec"}}
    (c1, _), (c2, _), (e2e, kw) = calls
    for cmd, cfg in ((c1, "1"), (c2, "2")):
        assert cmd[1:3] == ["-m", "kafka_topic_analyzer_tpu_torch.tools.bench"]
        assert cmd[cmd.index("--config") + 1] == cfg
        assert cmd[cmd.index("--device") + 1] == "cpu"
        assert cmd[cmd.index("--batch-size") + 1] == "4096"
        assert "--accuracy" in cmd
    assert e2e[1:3] == ["-m", "kafka_topic_analyzer_tpu_torch.tools.bench_e2e"]
    assert e2e[e2e.index("--backend") + 1] == "gpu"
    assert e2e[e2e.index("--device") + 1] == "cpu" and "--quiet" in e2e
    assert kw["cwd"] == REPO and kw["timeout"] == bench_all.E2E_TIMEOUT_S


def test_bench_all_reports_a_child_past_its_time(monkeypatch, capsys):
    def fake_run(cmd, **kw):
        if cmd[2].endswith("bench_e2e"):
            raise subprocess.TimeoutExpired(cmd, kw["timeout"])
        return _Done(0, json.dumps({"value": 1}) + "\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert bench_all.main(["--configs", "1"]) == 0
    report = last_json(capsys.readouterr().out)
    assert report["1"] == {"value": 1}
    assert report["e2e"] == {"error": "timed out after 900 s"}


def _batch(n: int, offsets: bool) -> "tuple[RecordBatch, RefBatch]":
    rng = np.random.default_rng(n)
    cols = {name: rng.integers(0, 100, n).astype(dt) for name, dt in RefBatch.FIELDS}
    cols["valid"] = np.ones(n, dtype=bool)
    port, ref = RecordBatch(**cols), RefBatch(**cols)
    if offsets:
        port.offsets = ref.offsets = np.arange(100, 100 + n, dtype=np.int64)
    return port, ref


@pytest.mark.parametrize("offsets", [False, True], ids=["gapless", "offsets"])
def test_pad_to_equals_the_references(offsets):
    port, ref = _batch(5, offsets)
    got, want = port.pad_to(8), ref.pad_to(8)
    for name, _ in RecordBatch.FIELDS:
        assert getattr(got, name).dtype == getattr(want, name).dtype
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.num_valid == 5 and not got.valid[5:].any()
    if offsets:
        np.testing.assert_array_equal(got.offsets, want.offsets)
        assert list(got.offsets[5:]) == [-1, -1, -1]
    else:
        assert got.offsets is None and want.offsets is None
    assert port.pad_to(5) is port
    with pytest.raises(ValueError, match="cannot pad to 4"):
        port.pad_to(4)
    with pytest.raises(ValueError, match="cannot pad to 4"):
        ref.pad_to(4)
