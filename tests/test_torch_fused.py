"""The port's fused sink and segment-file scan against the chained path,
the synthetic scan and the reference CLI.

`FusedPackSink` rows must equal the chained ``pack_batch`` rows of the
same records cut at the same boundaries (wire v4 and v5, compaction on and
off, rows spanning chunks and partitions, the partial last row, the
segment reader's ``ts_ms // 1000`` on negative and sub-second times).
Whole scans must print the same report whichever path ran: fused, chained
(``--native off``), synthetic, and the reference CLI's
``--source segfile --backend tpu``; with sparse partition ids, and at every
prefetch depth.  All comparisons are exact.
"""

import numpy as np
import pytest
import torch

from kafka_topic_analyzer_tpu import cli as ref_cli
from kafka_topic_analyzer_tpu_torch import cli, packing
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.io import native, segfile
from kafka_topic_analyzer_tpu_torch.io.segfile import SegmentFileSource
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.records import RecordBatch
from kafka_topic_analyzer_tpu_torch.report import render_report
from kafka_topic_analyzer_tpu_torch.tools.make_segments import make_segments

SYNTH = "partitions=3,messages=3000,keys=200,tombstones=150"
SPEC = SyntheticSpec.from_kv(dict(kv.split("=") for kv in SYNTH.split(",")))
SKETCHES = ["-c", "--distinct-keys-per-partition", "--quantiles-per-partition",
            "--pallas", "--batch-size", "1024", "--alive-bitmap-bits", "24"]
FORMATS = {"v5": [], "v4": ["--wire-format", "v4"],
           "compaction-off": ["--alive-compaction", "off"]}


def drop_timing(text: str) -> str:
    return "".join(
        line for line in text.splitlines(keepends=True)
        if not line.startswith(("Scanning took:", "Estimated Msg/s:"))
    )


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    out = tmp_path_factory.mktemp("seg")
    make_segments(str(out), "t", SPEC, use_native=True)
    return str(out)


def chunked_stream(seed: int):
    """Per-partition chunks (partition, columns, offsets or None) of one
    stream, with negative and sub-second millisecond timestamps."""
    rng = np.random.default_rng(seed)
    chunks = []
    for p, n in ((0, 700), (0, 90), (2, 1500), (3, 1), (3, 650), (1, 333)):
        key_null = rng.random(n) < 0.1
        cols = {
            "key_len": np.where(key_null, 0, rng.integers(1, 40, n)).astype(np.int32),
            "value_len": rng.integers(0, 3000, n).astype(np.int32),
            "key_null": key_null.astype(np.uint8),
            "value_null": (rng.random(n) < 0.15).astype(np.uint8),
            "ts_ms": rng.integers(-3_000_000, 3_000_000, n),
            "key_hash32": np.where(key_null, 0, rng.integers(0, 2**32, n, dtype=np.uint32)),
            "key_hash64": np.where(key_null, 0, rng.integers(0, 2**64, n, dtype=np.uint64)),
        }
        chunks.append((p, cols))
    return chunks


def as_batch(p: int, cols) -> RecordBatch:
    """The segment reader's batch of these columns."""
    n = len(cols["key_len"])
    return RecordBatch(
        partition=np.full(n, p, dtype=np.int32), key_len=cols["key_len"],
        value_len=cols["value_len"], key_null=cols["key_null"].view(bool),
        value_null=cols["value_null"].view(bool), ts_s=cols["ts_ms"] // 1000,
        key_hash32=cols["key_hash32"], key_hash64=cols["key_hash64"],
        valid=np.ones(n, dtype=bool),
    )


@pytest.mark.parametrize(
    "kw",
    [dict(count_alive_keys=True, alive_bitmap_bits=24,
          distinct_keys_per_partition=True, hll_p=12, quantiles_per_partition=True),
     dict(count_alive_keys=True, alive_bitmap_bits=14, enable_hll=True, hll_p=8,
          enable_quantiles=True),
     dict(count_alive_keys=True, alive_bitmap_bits=24, alive_compaction="off",
          distinct_keys_per_partition=True, hll_p=12),
     dict(wire_format=4, count_alive_keys=True, alive_bitmap_bits=24,
          distinct_keys_per_partition=True, hll_p=12, quantiles_per_partition=True,
          use_pallas_counters=True),
     dict(wire_format=4)],
    ids=["v5-pair-list", "v5-masks-global", "v5-compaction-off", "v4-pallas", "v4-plain"],
)
@pytest.mark.parametrize("b", [1024, 333])
def test_fused_rows_equal_chained_pack_batch(kw, b):
    # --pallas under v4 needs B % 1024 == 0.
    kw = dict(kw, use_pallas_counters=kw.get("use_pallas_counters", False) and b == 1024)
    config = AnalyzerConfig(num_partitions=4, batch_size=b, **kw)
    chunks = chunked_stream(seed=b)
    full = RecordBatch.concat([as_batch(p, c) for p, c in chunks])
    sink = packing.FusedPackSink(config, b, dense_of=lambda p: p)
    rows = []
    for p, cols in chunks:
        sink.append_columns(p, *(cols[k] for k, _ in segfile.COLUMNS),
                            len(cols["key_len"]), ts_mode=1)
        rows += sink.take_completed()
    sink.flush()
    rows += sink.take_completed()
    cuts = [full.slice(lo, min(lo + b, len(full))) for lo in range(0, len(full), b)]
    assert [r.n_valid for r in rows] == [len(c) for c in cuts]
    for k, (row, batch) in enumerate(zip(rows, cuts)):
        want = packing.pack_batch(batch, config, use_native=True)
        assert row.buf.tobytes() == want.tobytes(), f"row {k}"
        if config.compact_alive:
            for got, exp in zip(row.pairs, native.dedupe_slots_native(
                    batch.key_hash32, ~batch.key_null, ~batch.value_null,
                    config.alive_bitmap_bits)):
                np.testing.assert_array_equal(got, exp)
        else:
            assert row.pairs is None
    assert rows[-1].last_ts_s == int(chunks[-1][1]["ts_ms"][-1] // 1000)
    totals: "dict[int, int]" = {}
    for row in rows:
        for p, c in row.counts.items():
            totals[p] = totals.get(p, 0) + c
    assert totals == {0: 790, 2: 1500, 3: 651, 1: 333}


def test_segfile_fused_rows_equal_read_batch_then_pack(tmp_path):
    """The segment source's fused rows against its chained batches,
    concatenated and cut at B, then packed: gappy chunks, resumed."""
    chunks = chunked_stream(seed=3)
    for i, (p, cols) in enumerate(chunks):
        n = len(cols["key_len"])
        segfile.write_segment(str(tmp_path / f"s-{p}.c{i}.ktaseg"), p, 10_000 * i,
                              cols, np.arange(n, dtype=np.int64) * 2 + 10_000 * i)
    config = AnalyzerConfig(num_partitions=4, batch_size=256, count_alive_keys=True,
                            alive_bitmap_bits=20, enable_hll=True, hll_p=8,
                            quantiles_per_partition=True, wire_format=4)
    src = SegmentFileSource(str(tmp_path), "s")
    start_at = {0: 301, 2: 20_901}
    sink = packing.FusedPackSink(config, 256, dense_of=lambda p: p)
    rows = list(src.batches(256, start_at=start_at, sink=sink))
    full = RecordBatch.concat(list(src.batches(256, start_at=start_at)))
    assert sum(r.n_valid for r in rows) == len(full)
    for k, row in enumerate(rows):
        want = packing.pack_batch(full.slice(256 * k, 256 * (k + 1)), config)
        got_u, want_u = packing.unpack_numpy(row.buf, config), packing.unpack_numpy(want, config)
        for name in got_u:
            if name.startswith("alive"):
                continue  # pair order: first-touch (native) against slot order
            np.testing.assert_array_equal(got_u[name], want_u[name], name)
    assert rows[-1].next_offsets == {3: 2 * 649 + 40_000 + 1}  # partitions in id order


def port_cli(argv, capsys) -> str:
    assert cli.main(argv) == 0
    return drop_timing(capsys.readouterr().out)


@pytest.mark.parametrize("fmt", FORMATS.values(), ids=FORMATS.keys())
def test_segfile_reports_equal_fused_chained_synthetic_and_reference(dump, capsys, fmt):
    seg = ["-t", "t", "--source", "segfile", "--segment-dir", dump, *SKETCHES, *fmt]
    assert ref_cli.main(seg + ["--backend", "tpu"]) == 0
    want = drop_timing(capsys.readouterr().out)
    assert "Alive keys:" in want
    for flags in (["--native", "on"], ["--native", "off"], ["--native", "auto"]):
        assert port_cli(seg + ["--device", "cpu", *flags], capsys) == want, flags
    synth = ["-t", "t", "--source", "synthetic", "--synthetic", SYNTH, *SKETCHES, *fmt,
             "--device", "cpu"]
    assert port_cli(synth + ["--native", "off"], capsys) == want
    assert port_cli(synth + ["--native", "on"], capsys) == want


def test_engine_takes_the_fused_path_only_when_asked_and_loaded(dump):
    config = AnalyzerConfig(num_partitions=3, batch_size=1024, count_alive_keys=True,
                            alive_bitmap_bits=24)
    results = {}
    for use_native in (True, False):
        backend = TorchBackend(config, init_now_s=0, device="cpu", use_native=use_native)
        results[use_native] = run_scan("t", SegmentFileSource(dump, "t"), backend, 1024)
        assert results[use_native].fused == use_native
        assert results[use_native].records == 9000
    # Fused rows fill across partitions (9 rows); the chain cuts per chunk.
    assert (results[True].metrics.alive_keys, results[True].records) == \
        (results[False].metrics.alive_keys, results[False].records)
    synth = run_scan("t", SyntheticSource(SPEC), TorchBackend(
        config, init_now_s=0, device="cpu", use_native=True), 1024)
    assert synth.fused is False  # the synthetic source yields decoded batches


@pytest.mark.parametrize("native_flag", ["on", "off"])
def test_sparse_partitions_print_their_true_ids(tmp_path, capsys, native_flag):
    spec = SyntheticSpec.from_kv({"partitions": "8", "messages": "1500", "keys": "90"})
    src = SyntheticSource(spec)
    for p in (0, 3, 7):
        segfile.write_segment_from_batches(
            str(tmp_path), "sp", p, list(src.batches(4096, partitions=[p])))
    argv = ["-t", "sp", "--source", "segfile", "--segment-dir", str(tmp_path),
            *SKETCHES, "--wire-format", "v4"]
    assert ref_cli.main(argv + ["--backend", "tpu"]) == 0
    want = drop_timing(capsys.readouterr().out)
    got = port_cli(argv + ["--device", "cpu", "--native", native_flag], capsys)
    assert got == want
    rows = [line.split("|")[1].strip() for line in got.splitlines()
            if line.startswith("| ") and line.split("|")[1].strip().isdigit()]
    assert rows == ["0", "3", "7"]
    assert "partition 7 size quantiles:" in got


@pytest.mark.parametrize("wire_format", [5, 4])
def test_prefetch_depths_give_equal_reports(dump, wire_format):
    config = AnalyzerConfig(num_partitions=3, batch_size=700, count_alive_keys=True,
                            alive_bitmap_bits=24, distinct_keys_per_partition=True,
                            quantiles_per_partition=True, wire_format=wire_format)
    reports = set()
    for depth in (0, 1, 2, 5):
        for source in (SegmentFileSource(dump, "t"), SyntheticSource(SPEC)):
            backend = TorchBackend(config, init_now_s=0, device="cpu", use_native=True,
                                   prefetch_depth=depth)
            r = run_scan("t", source, backend, 700, prefetch_depth=depth)
            reports.add(render_report("t", r.metrics, r.start_offsets, r.end_offsets, 0,
                                      show_alive_keys=True))
    assert len(reports) == 1


def test_cli_errors_match_the_reference(tmp_path, capsys):
    """Missing --segment-dir and an empty catalog exit with the
    reference's messages (SystemExit: status 1); a damaged dump is one
    ``error:`` line and status 1 in both."""
    base = ["-t", "t", "--source", "segfile"]
    for argv in (base, base + ["--segment-dir", str(tmp_path)]):
        with pytest.raises(SystemExit) as ref_exit:
            ref_cli.main(argv + ["--backend", "tpu"])
        with pytest.raises(SystemExit) as port_exit:
            cli.main(argv + ["--device", "cpu"])
        assert str(port_exit.value) == str(ref_exit.value)
        assert isinstance(port_exit.value.code, str)  # printed; exit status 1
    (tmp_path / "t-0.ktaseg").write_bytes(b"KTASEG01\x00")
    argv = base + ["--segment-dir", str(tmp_path)]
    assert ref_cli.main(argv + ["--backend", "tpu"]) == 1
    ref_err = capsys.readouterr().err
    assert cli.main(argv + ["--device", "cpu"]) == 1
    assert capsys.readouterr().err == ref_err
    assert "truncated header" in ref_err


@pytest.mark.cuda
def test_cuda_segfile_scan_equals_cpu_scan(dump, capsys):
    """On a card: the fused and chained segment-file scans on cuda print
    the cpu scan's report."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the counter kernels have no CPU mode)")
    argv = ["-t", "t", "--source", "segfile", "--segment-dir", dump, *SKETCHES]
    for fmt in FORMATS.values():
        want = port_cli(argv + fmt + ["--device", "cpu"], capsys)
        for flag in ("on", "off"):
            assert port_cli(argv + fmt + ["--backend", "gpu", "--native", flag],
                            capsys) == want
