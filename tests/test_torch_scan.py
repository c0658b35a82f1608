"""The whole slice: the port's engine + TorchBackend (on the CPU) against
the reference's ``run_scan`` + ``TpuBackend`` with ``use_pallas_counters``
(the Pallas merge kernel in interpret mode), and the two CLIs.

Every ``TopicMetrics`` field and the rendered report must be equal, and
the CLIs must print identical stdout once the two timing lines are
dropped.  Comparisons are exact: every fold is an integer reduction and
the finalize code (popcount, HLL estimate, DDSketch quantiles) is the
reference's, copied.  ``init_now_s`` is fixed at 0 on both sides.
"""

import dataclasses

import jax
import numpy as np
import pytest

from kafka_topic_analyzer_tpu import cli as ref_cli
from kafka_topic_analyzer_tpu.backends.tpu import TpuBackend
from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefConfig
from kafka_topic_analyzer_tpu.engine import run_scan as ref_run_scan
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSource as RefSource
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSpec as RefSpec
from kafka_topic_analyzer_tpu.report import render_report as ref_render_report
from kafka_topic_analyzer_tpu_torch import cli
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.models.state import state_from_numpy
from kafka_topic_analyzer_tpu_torch.records import RecordBatch
from kafka_topic_analyzer_tpu_torch.report import render_report

SPEC = dict(num_partitions=5, messages_per_partition=3000, keys_per_partition=80,
            tombstone_permille=200)
SLICE = dict(count_alive_keys=True, alive_bitmap_bits=24,
             distinct_keys_per_partition=True, quantiles_per_partition=True,
             use_pallas_counters=True)


def assert_metrics_equal(port, ref):
    for field in dataclasses.fields(port):
        got, want = getattr(port, field.name), getattr(ref, field.name)
        if field.name == "quantiles" and got is not None:
            got, want = got.values, want.values
        if field.name == "quantiles_per_partition" and got is not None:
            got = [q.values for q in got]
            want = [q.values for q in want]
        # NaN quantiles (a partition without sized messages) compare equal.
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=field.name)


def scan_both(batch_size, **features):
    kw = {"num_partitions": SPEC["num_partitions"], "batch_size": batch_size,
          **features}
    ref = ref_run_scan(
        "t", RefSource(RefSpec(**SPEC)),
        TpuBackend(RefConfig(**kw), init_now_s=0), batch_size,
    )
    port = run_scan(
        "t", SyntheticSource(SyntheticSpec(**SPEC)),
        TorchBackend(AnalyzerConfig(**kw), init_now_s=0, device="cpu"), batch_size,
    )
    return ref, port


@pytest.mark.parametrize(
    "batch_size, features",
    [
        (2048, SLICE),
        (1001, SLICE),  # odd batch size: misaligned sections, partial tail
        (2048, dict(count_alive_keys=True, alive_bitmap_bits=16, enable_hll=True,
                    enable_quantiles=True, use_pallas_counters=True)),
    ],
    ids=["slice", "slice-odd-batch", "global-sketches-masks"],
)
def test_scan_matches_reference_metrics_and_report(batch_size, features):
    ref, port = scan_both(batch_size, **features)
    assert port.metrics.overall_count == 15000
    assert_metrics_equal(port.metrics, ref.metrics)
    assert (port.start_offsets, port.end_offsets) == (ref.start_offsets, ref.end_offsets)
    args = ("t", port.start_offsets, port.end_offsets, 0)
    assert render_report(args[0], port.metrics, *args[1:], show_alive_keys=True) == \
        ref_render_report(args[0], ref.metrics, *args[1:], show_alive_keys=True)


def drop_timing(text: str) -> str:
    return "".join(
        line for line in text.splitlines(keepends=True)
        if not line.startswith(("Scanning took:", "Estimated Msg/s:"))
    )


def test_cli_stdout_matches_reference_cli(capsys):
    argv = ["-t", "orders", "--source", "synthetic", "--synthetic",
            "partitions=3,messages=4000,keys=300,tombstones=150",
            "-c", "--distinct-keys-per-partition", "--quantiles-per-partition",
            "--pallas", "--batch-size", "4096", "--alive-bitmap-bits", "32"]
    assert ref_cli.main(argv + ["--backend", "tpu", "--native", "off"]) == 0
    ref_out = capsys.readouterr().out
    assert cli.main(argv + ["--backend", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert "Alive keys:" in port_out and "Estimated Msg/s:" in port_out
    assert drop_timing(port_out) == drop_timing(ref_out)


def test_cli_empty_topic_exits_254_and_bad_spec_exits_1(capsys):
    assert cli.main(["-t", "t", "--synthetic", "messages=0", "--backend", "cpu"]) == 254
    assert "no content" in capsys.readouterr().err
    assert cli.main(["-t", "t", "--synthetic", "keys=0", "--backend", "cpu"]) == 1
    assert "bad --synthetic key 'keys'" in capsys.readouterr().err


def test_state_carried_mid_scan_from_reference_finishes_in_the_port():
    """Fold half the batches in the reference, carry its state into the
    port, fold the rest there: the result equals the whole reference
    scan."""
    kw = {"num_partitions": SPEC["num_partitions"], "batch_size": 2048, **SLICE}
    ref_cfg = RefConfig(**kw)
    whole = ref_run_scan("t", RefSource(RefSpec(**SPEC)),
                         TpuBackend(ref_cfg, init_now_s=0), 2048).metrics
    batches = list(RefSource(RefSpec(**SPEC)).batches(2048))
    half = len(batches) // 2
    ref_backend = TpuBackend(ref_cfg, init_now_s=0)
    for batch in batches[:half]:
        ref_backend.update(batch)
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(ref_backend.get_state()))
    leaves = {jax.tree_util.keystr(p).lstrip("."): np.array(x) for p, x in flat}
    backend = TorchBackend(AnalyzerConfig(**kw), init_now_s=0, device="cpu")
    backend.state = state_from_numpy(leaves, device=backend.device)
    for batch in batches[half:]:
        backend.update(RecordBatch(**batch.as_dict()))
    assert backend.dispatches == len(batches) - half
    assert_metrics_equal(backend.finalize(), whole)


@pytest.mark.parametrize(
    "kwargs",
    [dict(wire_format=4), dict(alive_compaction="off"), dict(mesh_shape=(2, 1))],
)
def test_config_refuses_what_is_not_yet_ported(kwargs):
    with pytest.raises(ValueError, match="not yet ported"):
        AnalyzerConfig(**kwargs)
