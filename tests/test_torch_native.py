"""The port's native ingest shim against numpy and against the reference's
shim, on the CPU (``g++`` builds it here).

The port builds its own copy of ``native/ingest.cpp`` into
``build/torch_native/`` under its own file name, loads it next to the
reference's library in this process, and must give the same bytes: the
synthetic records, the packed rows (wire v4 and v5, alive pairs per row or
compacted, every HLL section form, quantiles, odd batch sizes) and the
compacted pair tables.  Against the port's own numpy packers the rows are
equal once the alive pairs are put in slot order (the native dedupe emits
them first-touch, numpy by slot).  All comparisons are exact.
"""

import pathlib

import numpy as np
import pytest

from kafka_topic_analyzer_tpu import packing as ref_packing
from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefConfig
from kafka_topic_analyzer_tpu.io import native as ref_native
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSpec as RefSpec
from kafka_topic_analyzer_tpu.records import RecordBatch as RefBatch
from kafka_topic_analyzer_tpu_torch import _build, cli, packing
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.io import native
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.records import RecordBatch

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPEC = dict(num_partitions=5, messages_per_partition=1700, keys_per_partition=120,
            tombstone_permille=150, seed=21)


def as_ref(batch: RecordBatch) -> RefBatch:
    return RefBatch(**batch.as_dict())


def random_batch(seed: int, n: int, parts: int, valid: "int | None" = None) -> RecordBatch:
    """Records with null keys, tombstones, negative and sub-second
    timestamps, hashes over the full ranges, and an invalid tail."""
    rng = np.random.default_rng(seed)
    key_null = rng.random(n) < 0.1
    value_null = rng.random(n) < 0.15
    batch = RecordBatch(
        partition=rng.integers(0, parts, n).astype(np.int32),
        key_len=np.where(key_null, 0, rng.integers(0, 70, n)).astype(np.int32),
        value_len=np.where(value_null, 0, rng.integers(0, 5000, n)).astype(np.int32),
        key_null=key_null,
        value_null=value_null,
        ts_s=rng.integers(-(2**33), 2**33, n),
        key_hash32=np.where(key_null, 0, rng.integers(0, 2**32, n, dtype=np.uint32)),
        key_hash64=np.where(key_null, 0, rng.integers(0, 2**64, n, dtype=np.uint64)),
        valid=np.arange(n) < (n if valid is None else valid),
    )
    return batch


def canonical_pairs(row: np.ndarray, config, capacity=None) -> bytes:
    """``row`` (or, with ``capacity``, a pair table) with its alive pair
    list in slot order."""
    row = row.copy()
    n = int(row[:16].view(np.int32)[1])
    secs, pos = {}, packing.HEADER_BYTES
    for name, dtype, count in packing._sections(
        config, capacity or config.batch_size, pair_table=capacity is not None
    ):
        nb = np.dtype(dtype).itemsize * count
        secs[name] = row[pos : pos + nb].view(dtype)
        pos += nb
    if "alive_slot" in secs:
        order = np.argsort(secs["alive_slot"][:n], kind="stable")
        secs["alive_slot"][:n] = secs["alive_slot"][:n][order]
        secs["alive_flag"][:n] = secs["alive_flag"][:n][order]
    return row.tobytes()


def test_library_builds_under_build_torch_native_from_the_ports_source():
    assert native.native_status() == (True, "")
    path = _build.native_library_path()
    assert path.parent == ROOT / "build" / "torch_native"
    assert path.name.startswith("libkta_ingest_torch-") and path.exists()
    assert (ROOT / "kafka_topic_analyzer_tpu_torch" / _build.NATIVE_SOURCE).is_file()
    assert native.load_library()._name == str(path)
    # The reference's shim loads in the same process from its own file.
    ref_lib = ref_native.load_library()
    assert pathlib.Path(ref_lib._name).name != path.name
    assert "kafka_topic_analyzer_tpu_torch" not in ref_lib._name
    assert native.load_library().kta_version() == ref_lib.kta_version() == native.ABI


def test_no_port_file_builds_or_loads_the_references_shim():
    """The import scan cannot see a path into the reference's native/."""
    port = ROOT / "kafka_topic_analyzer_tpu_torch"
    files = sorted(port.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        text = path.read_text()
        for needle in ("kafka_topic_analyzer_tpu/native", "libkta_ingest.v"):
            assert needle not in text, f"{path.name} names {needle}"


def test_failed_build_is_classified_cached_and_honoured_by_the_cli(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(_build, "native_library_path", lambda: tmp_path / "missing.so")
    calls = []

    def which(name):
        calls.append(name)
        return None

    monkeypatch.setattr(_build.shutil, "which", which)
    assert native.native_status() == (False, "build-failed")
    assert native.native_status() == (False, "build-failed")
    assert calls == ["g++"]  # the failure is remembered, not rebuilt
    with pytest.raises(_build.BuildError, match="g\\+\\+ not found on PATH"):
        native.load_library()
    argv = ["-t", "t", "--source", "synthetic",
            "--synthetic", "partitions=2,messages=300,keys=20",
            "--device", "cpu", "--batch-size", "128"]
    with pytest.raises(_build.BuildError):
        cli.main(argv + ["--native", "on"])
    args = cli.build_parser().parse_args(argv)
    source, _, use_native = cli.setup(args)
    assert not use_native and type(source) is SyntheticSource
    assert cli.main(argv) == 0  # auto falls back to numpy


@pytest.mark.parametrize(
    "partitions, start_at, batch_size",
    [(None, None, 1024), (None, None, 777), ([3, 1], None, 500),
     (None, {0: 900, 2: 1699, 4: 5000}, 256)],
    ids=["round-robin", "odd-batch", "partition-subset", "start-at-resume"],
)
def test_native_synth_matches_numpy_and_reference(partitions, start_at, batch_size):
    spec = SyntheticSpec(**SPEC)
    want = list(SyntheticSource(spec).batches(batch_size, partitions, start_at))
    got = list(native.NativeSyntheticSource(spec, threads=3).batches(
        batch_size, partitions, start_at))
    ref = list(ref_native.NativeSyntheticSource(RefSpec(**SPEC)).batches(
        batch_size, partitions, start_at))
    assert len(got) == len(want) == len(ref) > 0
    for g, w, r in zip(got, want, ref):
        for name, _ in RecordBatch.FIELDS:
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), name)
            np.testing.assert_array_equal(getattr(g, name), getattr(r, name), name)


def test_hash_dedupe_and_masks_match_the_reference():
    rng = np.random.default_rng(5)
    lengths = rng.integers(0, 40, 300)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    data = rng.integers(0, 256, int(offsets[-1]), dtype=np.uint8)
    for got, want in zip(native.hash_batch_native(data, offsets, threads=2),
                         ref_native.hash_batch_native(data, offsets, threads=2)):
        np.testing.assert_array_equal(got, want)
    h32 = rng.integers(0, 2**32, 5000, dtype=np.uint32)
    active, alive = rng.random(5000) < 0.9, rng.random(5000) < 0.7
    for bits in (6, 16, 32):
        got = native.dedupe_slots_native(h32, active, alive, bits)
        ref = ref_native.dedupe_slots_native(h32, active, alive, bits)
        want = packing.dedupe_slots_numpy(h32, active, alive, bits)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        order = np.argsort(got[0])
        np.testing.assert_array_equal(got[0][order], want[0])
        np.testing.assert_array_equal(got[1][order], want[1])
    slots = rng.integers(0, 1 << 12, 3000, dtype=np.uint32)
    flags = (rng.random(3000) < 0.5).astype(np.uint8)
    outs = [np.full(1 << 7, 7, dtype=np.uint32) for _ in range(4)]
    assert native.pairs_to_masks_native(slots, flags, 12, *outs[:2]) == \
        ref_native.pairs_to_masks_native(slots, flags, 12, *outs[2:]) == len(np.unique(slots))
    np.testing.assert_array_equal(outs[0], outs[2])
    np.testing.assert_array_equal(outs[1], outs[3])


#: (config kwargs) across wire v4/v5 × compaction auto/off × the HLL
#: section forms × quantiles × odd batch sizes.
PACK_CASES = {
    "v5_hll-table-global_quant-global_masks": dict(
        count_alive_keys=True, alive_bitmap_bits=16, enable_hll=True, hll_p=10,
        enable_quantiles=True),
    "v5_hll-flat-pairs_quant-pp_pair-list": dict(
        count_alive_keys=True, alive_bitmap_bits=24,
        distinct_keys_per_partition=True, hll_p=12, quantiles_per_partition=True),
    "v5_hll-table-pp_odd-batch": dict(
        batch_size=1001, count_alive_keys=True, alive_bitmap_bits=24,
        distinct_keys_per_partition=True, hll_p=8, quantiles_per_partition=True),
    "v5_compaction-off_hll-u16-pairs": dict(
        count_alive_keys=True, alive_bitmap_bits=20, alive_compaction="off",
        enable_hll=True, hll_p=16, quantiles_per_partition=True),
    "v5_compaction-off_odd-batch_32-bit-slots": dict(
        batch_size=999, count_alive_keys=True, alive_bitmap_bits=32,
        alive_compaction="off", distinct_keys_per_partition=True, hll_p=12),
    "v4_hll-pp-pairs_quant-pp": dict(
        wire_format=4, count_alive_keys=True, alive_bitmap_bits=24,
        distinct_keys_per_partition=True, hll_p=12, quantiles_per_partition=True,
        use_pallas_counters=True),
    "v4_odd-batch_hll-table-global": dict(
        wire_format=4, batch_size=1001, count_alive_keys=True,
        alive_bitmap_bits=16, enable_hll=True, hll_p=8, enable_quantiles=True),
    "v4_plain": dict(wire_format=4),
}


@pytest.mark.parametrize("kw", PACK_CASES.values(), ids=PACK_CASES.keys())
def test_pack_batch_native_matches_numpy_and_reference(kw):
    kw = dict(kw)
    b = kw.pop("batch_size", 2048)
    config = AnalyzerConfig(num_partitions=5, batch_size=b, **kw)
    ref_config = RefConfig(num_partitions=5, batch_size=b, **kw)
    spec = SyntheticSpec(**SPEC)
    batches = list(SyntheticSource(spec).batches(b))[:3]
    batches += [random_batch(3, b - 17, 5), RecordBatch.empty(0),
                random_batch(4, b - 17, 5, valid=b - 100)]
    for i, batch in enumerate(batches):
        got = packing.pack_batch(batch, config, use_native=True)
        ref = ref_packing.pack_batch(as_ref(batch), ref_config, use_native=True)
        want = packing.pack_batch(batch, config)
        assert got.tobytes() == ref.tobytes()
        if i < len(batches) - 1:
            # The columns of an invalid tail differ between the packers
            # (numpy copies them, the shim zeroes them); the device reads
            # only the valid prefix.
            assert canonical_pairs(got, config) == canonical_pairs(want, config)
        row = np.full(packing.packed_nbytes(config, b), 0xAB, dtype=np.uint8)
        assert packing.pack_batch(batch, config, use_native=True, out=row) is row
        assert row.tobytes() == got.tobytes()
        if config.compact_alive:
            cap = packing.pair_table_capacity(config, b)
            pairs = packing.batch_alive_pairs(batch, config, use_native=True)
            table, raw, emitted = packing.pack_pair_table([pairs], config, cap,
                                                          use_native=True)
            ref_table, ref_raw, ref_emitted = ref_packing.pack_pair_table(
                [ref_packing.batch_alive_pairs(as_ref(batch), ref_config, True)],
                ref_config, cap, use_native=True)
            np_table, _, np_emitted = packing.pack_pair_table(
                [packing.batch_alive_pairs(batch, config)], config, cap)
            assert table.tobytes() == ref_table.tobytes()
            assert (raw, emitted) == (ref_raw, ref_emitted)
            assert emitted == np_emitted
            assert canonical_pairs(table, config, cap) == canonical_pairs(np_table, config, cap)


@pytest.mark.parametrize("bits, mode", [(14, 2), (24, 1)], ids=["masks", "pair-list"])
def test_pack_pair_table_native_matches_numpy(bits, mode):
    config = AnalyzerConfig(num_partitions=3, batch_size=4096, count_alive_keys=True,
                            alive_bitmap_bits=bits)
    cap = packing.pair_table_capacity(config, 4096)
    assert packing.alive_table_mode(config, cap) == mode
    rng = np.random.default_rng(bits)
    # Three batches' deduped lists, merged in stream order: later wins.
    lists = []
    for _ in range(3):
        h32 = rng.integers(0, 1 << 12, 1300, dtype=np.uint32)
        lists.append(packing.dedupe_slots_numpy(
            h32, rng.random(1300) < 0.9, rng.random(1300) < 0.6, bits))
    got, raw, emitted = packing.pack_pair_table(lists, config, cap, use_native=True)
    want, want_raw, want_emitted = packing.pack_pair_table(lists, config, cap)
    assert (raw, emitted) == (want_raw, want_emitted)
    assert canonical_pairs(got, config, cap) == canonical_pairs(want, config, cap)
    if mode == 2:
        assert got.tobytes() == want.tobytes()


def test_pallas_value_cap_refused_by_native_pack_and_fused_append():
    config = AnalyzerConfig(num_partitions=2, batch_size=1024, wire_format=4,
                            use_pallas_counters=True)
    batch = random_batch(9, 300, 2)
    batch.partition[:] = 1
    batch.value_len[7] = (1 << 24)
    batch.value_null[7] = False
    msg = "exceeds the Pallas counter kernel's limit of 16777215 bytes"
    with pytest.raises(ValueError, match=msg):
        packing.pack_batch(batch, config, use_native=True)
    with pytest.raises(ValueError, match=msg):
        ref_packing.pack_batch(as_ref(batch), RefConfig(
            num_partitions=2, batch_size=1024, wire_format=4,
            use_pallas_counters=True), use_native=True)
    sink = packing.FusedPackSink(config, 1024, dense_of=lambda p: p)
    with pytest.raises(ValueError, match=msg):
        sink.append_batch(batch, "frame-fallback")
    # Under wire v5 no per-record length reaches a counter kernel.
    v5 = AnalyzerConfig(num_partitions=2, batch_size=1024, use_pallas_counters=True)
    assert packing.pack_batch(batch, v5, use_native=True).tobytes() == \
        packing.pack_batch(batch, v5).tobytes()
