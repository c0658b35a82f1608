"""The whole slice: the port's engine + TorchBackend (on the CPU) against
the reference's ``run_scan`` + ``TpuBackend`` with ``use_pallas_counters``
(the Pallas merge kernel on wire v5, the Pallas counter kernel on wire
v4, both in interpret mode), and the two CLIs.

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
SLICE_V4 = dict(SLICE, wire_format=4)


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
        (2048, SLICE_V4),
        (1001, dict(SLICE_V4, use_pallas_counters=False)),
        (2048, dict(count_alive_keys=True, alive_bitmap_bits=16, enable_hll=True,
                    enable_quantiles=True, wire_format=4)),
        (2048, dict(SLICE, alive_compaction="off")),
        (1001, dict(SLICE, alive_compaction="off")),
    ],
    ids=["slice", "slice-odd-batch", "global-sketches-masks", "v4",
         "v4-odd-batch", "v4-global-sketches", "compaction-off",
         "compaction-off-odd-batch"],
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
    assert cli.main(argv + ["--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert "Alive keys:" in port_out and "Estimated Msg/s:" in port_out
    assert drop_timing(port_out) == drop_timing(ref_out)


#: Reference flags the port's CLI refused before it ported them.
REFERENCE_FLAGS = {
    "quiet": ["--quiet"],
    "distinct-keys": ["--distinct-keys"],
    "quantiles": ["--quantiles"],
    "extremes-table": ["--extremes-table"],
    "profile-dir": ["--profile-dir"],
    "all": ["--quiet", "--distinct-keys", "--quantiles", "--extremes-table"],
}


@pytest.mark.parametrize("flag", list(REFERENCE_FLAGS))
def test_cli_reference_flags_give_the_reference_stdout(flag, tmp_path, capsys):
    argv = ["-t", "orders", "--source", "synthetic", "--synthetic",
            "partitions=3,messages=4000,keys=300,tombstones=150",
            "-c", "--batch-size", "4096", "--alive-bitmap-bits", "24"]
    flags = REFERENCE_FLAGS[flag]
    if flag == "profile-dir":
        flags = flags + [str(tmp_path / "ref")]
    assert ref_cli.main(argv + flags + ["--backend", "tpu", "--native", "off"]) == 0
    ref_out = capsys.readouterr().out
    if flag == "profile-dir":
        flags = REFERENCE_FLAGS[flag] + [str(tmp_path / "port")]
    assert cli.main(argv + flags + ["--device", "cpu"]) == 0
    port = capsys.readouterr()
    assert drop_timing(port.out) == drop_timing(ref_out)
    if flag in ("quiet", "all"):
        assert port.err == ""
    if flag == "profile-dir":
        from kafka_topic_analyzer_tpu_torch.utils.profiling import TRACE_FILE

        assert (tmp_path / "port" / TRACE_FILE).stat().st_size > 0


@pytest.mark.parametrize(
    "flags",
    [["--wire-format", "v4", "--pallas"], ["--alive-compaction", "off", "--pallas"],
     ["--wire-format", "v4"]],
    ids=["v4-pallas", "compaction-off", "v4"],
)
def test_cli_stdout_matches_reference_cli_in_v4_and_compaction_off(capsys, flags):
    argv = ["-t", "orders", "--source", "synthetic", "--synthetic",
            "partitions=3,messages=4000,keys=300,tombstones=150",
            "-c", "--distinct-keys-per-partition", "--quantiles-per-partition",
            "--batch-size", "4096", "--alive-bitmap-bits", "24", *flags]
    assert ref_cli.main(argv + ["--backend", "tpu", "--native", "off"]) == 0
    ref_out = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert "Alive keys:" in port_out and "partition 2 size quantiles:" in port_out
    assert drop_timing(port_out) == drop_timing(ref_out)


def test_cli_pallas_v4_refusals_match_reference(capsys):
    """``--pallas`` under v4 refuses a batch size that is not a multiple
    of 1024 (exit 1) and a value over 16 MiB - 1 (at pack time), in both
    CLIs."""
    argv = ["-t", "t", "--source", "synthetic", "-c", "--pallas",
            "--wire-format", "v4", "--alive-bitmap-bits", "16"]
    bad_batch = argv + ["--synthetic", "partitions=2,messages=3000,keys=50",
                        "--batch-size", "1000"]
    assert ref_cli.main(bad_batch + ["--backend", "tpu", "--native", "off"]) == 1
    ref_err = capsys.readouterr().err
    assert cli.main(bad_batch + ["--device", "cpu"]) == 1
    assert capsys.readouterr().err == ref_err
    assert "batch_size % 1024 == 0" in ref_err
    big = argv + ["--synthetic",
                  "partitions=2,messages=300,keys=50,vmin=16777216,vmax=16777300",
                  "--batch-size", "1024"]
    with pytest.raises(ValueError, match="exceeds the Pallas counter kernel") as ref:
        ref_cli.main(big + ["--backend", "tpu", "--native", "off"])
    with pytest.raises(ValueError, match="exceeds the Pallas counter kernel") as port:
        cli.main(big + ["--device", "cpu"])
    assert str(port.value) == str(ref.value)
    capsys.readouterr()  # the refused scans' first lines
    # Without --pallas the same topic scans, exactly, in both.
    ok = [a for a in big if a != "--pallas"]
    assert ref_cli.main(ok + ["--backend", "tpu", "--native", "off"]) == 0
    ref_out = capsys.readouterr().out
    assert cli.main(ok + ["--device", "cpu"]) == 0
    assert drop_timing(capsys.readouterr().out) == drop_timing(ref_out)


def test_cli_empty_topic_exits_254_and_bad_spec_exits_1(capsys):
    assert cli.main(["-t", "t", "--source", "synthetic", "--synthetic", "messages=0",
                     "--device", "cpu"]) == 254
    assert "no content" in capsys.readouterr().err
    assert cli.main(["-t", "t", "--source", "synthetic", "--synthetic", "keys=0",
                     "--device", "cpu"]) == 1
    assert "bad --synthetic key 'keys'" in capsys.readouterr().err


def carry_mid_scan(features):
    """Fold half the batches in the reference, carry its state into the
    port, fold the rest there: returns (port metrics, whole reference
    scan's metrics)."""
    kw = {"num_partitions": SPEC["num_partitions"], "batch_size": 2048, **features}
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
    return backend.finalize(), whole


def test_state_carried_mid_scan_from_reference_finishes_in_the_port():
    assert_metrics_equal(*carry_mid_scan(SLICE))


def test_state_carried_mid_scan_under_wire_v4():
    """The v4 state has the v5 state's leaves: a JAX v4 scan carried
    mid-way into the port's v4 scan ends where the JAX scan ends."""
    assert_metrics_equal(*carry_mid_scan(SLICE_V4))


@pytest.mark.parametrize("kwargs", [
    dict(mesh_shape=(2, 2), batch_size=1001,
         message="batch_size must divide evenly into space_shards chunks"),
    dict(mesh_shape=(1, 4), batch_size=2048, wire_format=4, use_pallas_counters=True,
         message="use_pallas_counters requires a per-space-shard chunk "
                 "(batch_size / space_shards) that is a multiple of 1024"),
])
def test_config_refuses_what_is_not_yet_ported(kwargs):
    """Mesh shapes the sharded backend cannot run: the port's config
    check and the reference's backend raise the same message."""
    from kafka_topic_analyzer_tpu.parallel.sharded import ShardedTpuBackend

    kwargs = dict(kwargs)
    message = kwargs.pop("message")
    with pytest.raises(ValueError) as port_err:
        AnalyzerConfig(num_partitions=3, **kwargs).validate_mesh()
    with pytest.raises(ValueError) as ref_err:
        ShardedTpuBackend(RefConfig(num_partitions=3, **kwargs))
    assert str(port_err.value) == str(ref_err.value) == message


def test_fleet_still_refuses_a_mesh(capsys):
    argv = ["-t", "a", "--fleet", "--mesh", "2", "-b", "127.0.0.1:1"]
    assert cli.main(argv + ["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "--fleet does not support --mesh yet" in err
    assert ref_cli.main(argv) == 1
    assert capsys.readouterr().err == err


@pytest.mark.parametrize("kwargs", [
    dict(mesh_shape=(2, 1)), dict(mesh_shape=(2, 2), batch_size=2048),
    dict(mesh_shape=(1, 2), batch_size=2048, wire_format=4, use_pallas_counters=True),
    dict(mesh_shape=(8, 1), batch_size=1001),
], ids=["2x1", "2x2", "1x2-v4-pallas", "8x1-odd-batch"])
def test_config_accepts_mesh_shapes(kwargs):
    config = AnalyzerConfig(num_partitions=3, **kwargs)
    config.validate_mesh()
    d, s = kwargs["mesh_shape"]
    assert (config.data_shards, config.space_shards) == (d, s)
    assert config.chunk_size == config.batch_size // s


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(wire_format=4),
        dict(alive_compaction="off"),
        dict(count_alive_keys=True),
        dict(count_alive_keys=True, wire_format=4),
        dict(count_alive_keys=True, wire_format=5),
        dict(count_alive_keys=True, alive_compaction="off"),
        dict(count_alive_keys=True, wire_format=4, alive_compaction="off"),
        dict(wire_format=4, use_pallas_counters=True, batch_size=3072),
        dict(wire_format=5, use_pallas_counters=True, batch_size=1000),
    ],
)
def test_config_resolves_wire_format_and_compaction_like_reference(kwargs, monkeypatch):
    """wire v4 and compaction "off" build, and resolve ``wire_format``
    and ``compact_alive`` as the reference does (its environment
    switches, which the port leaves out, unset)."""
    monkeypatch.delenv("KTA_WIRE_V4", raising=False)
    monkeypatch.delenv("KTA_DISABLE_COMPACTION", raising=False)
    port, ref = AnalyzerConfig(**kwargs), RefConfig(**kwargs)
    assert (port.wire_format, port.compact_alive) == (ref.wire_format, ref.compact_alive)


@pytest.mark.parametrize(
    "kwargs, match",
    [
        (dict(wire_format=4, use_pallas_counters=True, batch_size=1000),
         "batch_size % 1024 == 0"),
        (dict(wire_format=3), "wire_format 3 invalid"),
        (dict(alive_compaction="on"), "alive_compaction 'on' invalid"),
    ],
)
def test_config_refusals_match_reference(kwargs, match):
    with pytest.raises(ValueError, match=match) as ref:
        RefConfig(**kwargs)
    with pytest.raises(ValueError, match=match) as port:
        AnalyzerConfig(**kwargs)
    assert str(port.value) == str(ref.value)
