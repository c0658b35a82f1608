"""The port's packers and unpackers (wire v5 with compacted or per-row
alive pairs, and wire v4) against the reference's.

The same records (from the synthetic generator, which must itself be
bit-identical across the two packages) go through the reference's numpy
packers (``use_native=False``) and the port's; the packed rows and pair
tables must be the same BYTES, and the port's device unpack (run on the
CPU here) must give the reference's host unpack field for field.  All
comparisons are exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kafka_topic_analyzer_tpu import packing as ref_packing
from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefConfig
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSource as RefSource
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSpec as RefSpec
from kafka_topic_analyzer_tpu.records import RecordBatch as RefBatch
from kafka_topic_analyzer_tpu_torch import packing
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.records import RecordBatch

SPEC = dict(num_partitions=4, messages_per_partition=1300, keys_per_partition=90,
            seed=7)

#: Feature combinations: (config kwargs, expected HLL wire mode, expected
#: alive table mode, None where the pairs ride the row per batch).  B =
#: 2048 unless given.
CASES = {
    "hll-table-global_quant-global_masks": (
        dict(enable_hll=True, hll_p=12, enable_quantiles=True,
             alive_bitmap_bits=20), 2, 2),
    "hll-flat-pairs_quant-pp_pair-list": (
        dict(distinct_keys_per_partition=True, hll_p=12,
             quantiles_per_partition=True, alive_bitmap_bits=24), 3, 1),
    "hll-u16-pairs_masks": (
        dict(enable_hll=True, hll_p=16, alive_bitmap_bits=20), 1, 2),
    "hll-table-pp_quant-pp": (
        dict(distinct_keys_per_partition=True, hll_p=9,
             quantiles_per_partition=True, alive_bitmap_bits=24), 2, 1),
    "odd-batch_hll-flat-pairs_quant-pp": (
        dict(batch_size=1001, distinct_keys_per_partition=True, hll_p=10,
             quantiles_per_partition=True, alive_bitmap_bits=24), 3, 1),
    "v4_hll-pp-pairs_quant-pp": (
        dict(wire_format=4, distinct_keys_per_partition=True, hll_p=12,
             quantiles_per_partition=True, alive_bitmap_bits=24), 1, None),
    "v4_hll-table-global_quant-global": (
        dict(wire_format=4, enable_hll=True, hll_p=10, enable_quantiles=True,
             alive_bitmap_bits=20), 2, None),
    "v4_odd-batch_hll-u16-pairs": (
        dict(wire_format=4, batch_size=1001, use_pallas_counters=False,
             enable_hll=True, hll_p=16, alive_bitmap_bits=24), 1, None),
    "v5-compaction-off_hll-flat-pairs_quant-pp": (
        dict(alive_compaction="off", distinct_keys_per_partition=True,
             hll_p=12, quantiles_per_partition=True, alive_bitmap_bits=24),
        3, None),
    "v5-compaction-off_odd-batch_hll-table-pp": (
        dict(alive_compaction="off", batch_size=999,
             distinct_keys_per_partition=True, hll_p=8,
             quantiles_per_partition=True, alive_bitmap_bits=32), 2, None),
}


def configs(kwargs):
    kw = {"num_partitions": SPEC["num_partitions"], "batch_size": 2048,
          "count_alive_keys": True, "use_pallas_counters": True, **kwargs}
    return RefConfig(**kw), AnalyzerConfig(**kw)


def ref_batches(batch_size):
    return list(RefSource(RefSpec(**SPEC)).batches(batch_size))


def as_port(batch: RefBatch) -> RecordBatch:
    return RecordBatch(**batch.as_dict())


def host(t: torch.Tensor, dtype) -> np.ndarray:
    out = t.numpy()
    return out if out.ndim == 0 else out.view(dtype)


def test_synthetic_records_are_bit_identical():
    ref = list(RefSource(RefSpec(**SPEC)).batches(1000))
    port = list(SyntheticSource(SyntheticSpec(**SPEC)).batches(1000))
    assert len(ref) == len(port) == 6
    for a, b in zip(ref, port):
        for name, _ in RefBatch.FIELDS:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_spec_from_kv_matches_reference():
    kv = {"partitions": "3", "messages": "10", "vmin": "500", "seed": "0x10"}
    assert dataclasses.asdict(SyntheticSpec.from_kv(kv)) == dataclasses.asdict(
        RefSpec.from_kv(kv)
    )
    with pytest.raises(ValueError, match="unknown --synthetic key 'bogus'"):
        SyntheticSpec.from_kv({"bogus": "1"})


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_rows_and_pair_tables_are_byte_identical(case):
    kwargs, hll_mode, alive_mode = CASES[case]
    ref_cfg, cfg = configs(kwargs)
    b = cfg.batch_size
    cap = packing.pair_table_capacity(cfg, b)
    assert cap == ref_packing.pair_table_capacity(ref_cfg, b, 1)
    assert packing.hll_wire_mode(cfg, b) == ref_packing.hll_wire_mode(ref_cfg, b) == hll_mode
    assert cfg.compact_alive == ref_cfg.compact_alive == (alive_mode is not None)
    assert packing._sections(cfg, b) == ref_packing._sections(ref_cfg, b)
    batches = ref_batches(b) + [RefBatch.empty(0)]  # partial tail, then empty
    for batch in batches:
        row = packing.pack_batch(as_port(batch), cfg)
        ref_row = ref_packing.pack_batch(batch, ref_cfg, use_native=False)
        assert row.tobytes() == ref_row.tobytes()
        if alive_mode is None:
            continue  # the pairs rode the row, n_pairs in its header
        assert packing.alive_table_mode(cfg, cap) == alive_mode
        pairs = [packing.batch_alive_pairs(as_port(batch), cfg)]
        ref_pairs = [ref_packing.batch_alive_pairs(batch, ref_cfg, use_native=False)]
        table, raw, emitted = packing.pack_pair_table(pairs, cfg, cap)
        ref_table, ref_raw, ref_emitted = ref_packing.pack_pair_table(
            ref_pairs, ref_cfg, cap, use_native=False
        )
        assert (raw, emitted) == (ref_raw, ref_emitted)
        assert table.tobytes() == ref_table.tobytes()


def test_pair_table_merges_lists_last_writer_wins():
    ref_cfg, cfg = configs(dict(alive_bitmap_bits=24))
    lists = [
        (np.array([5, 9, 70], dtype=np.uint32), np.array([1, 1, 0], dtype=np.uint8)),
        (np.array([9, 5], dtype=np.uint32), np.array([0, 1], dtype=np.uint8)),
    ]
    table, raw, emitted = packing.pack_pair_table(lists, cfg, 2048)
    ref_table, _, _ = ref_packing.pack_pair_table(lists, ref_cfg, 2048, use_native=False)
    assert (raw, emitted) == (5, 3)
    assert table.tobytes() == ref_table.tobytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_unpack_matches_reference_host_unpack(case):
    kwargs, _, alive_mode = CASES[case]
    ref_cfg, cfg = configs(kwargs)
    cap = packing.pair_table_capacity(cfg, cfg.batch_size)
    batch = ref_batches(cfg.batch_size)[-1]  # the partial tail
    row = packing.pack_batch(as_port(batch), cfg)
    got = packing.unpack_device(torch.from_numpy(row), cfg)
    want = ref_packing.unpack_numpy(row, ref_cfg)
    assert sorted(got) == sorted(want)
    for name, exp in want.items():
        exp = np.asarray(exp)
        np.testing.assert_array_equal(host(got[name], exp.dtype), exp, err_msg=name)
    if alive_mode is None:
        assert int(got["n_pairs"]) > 0 and "alive_slot" in got
        return
    table, _, _ = packing.pack_pair_table(
        [packing.batch_alive_pairs(as_port(batch), cfg)], cfg, cap
    )
    got = packing.unpack_pair_table_device(torch.from_numpy(table), cfg, cap)
    want = ref_packing.unpack_pair_table_numpy(table, ref_cfg, cap)
    assert sorted(got) == sorted(want)
    for name, exp in want.items():
        exp = np.asarray(exp)
        np.testing.assert_array_equal(host(got[name], exp.dtype), exp, err_msg=name)


def section_offsets(cfg) -> "dict[str, int]":
    """Each section's byte offset in a packed row, from `packing._sections`
    and `packing.packed_nbytes` (the header is what the sections leave)."""
    secs = packing._sections(cfg, cfg.batch_size)
    sizes = [np.dtype(dtype).itemsize * count for _, dtype, count in secs]
    pos = packing.packed_nbytes(cfg, cfg.batch_size) - sum(sizes)
    offsets = {}
    for (name, _, _), size in zip(secs, sizes):
        offsets[name] = pos
        pos += size
    return offsets


def test_odd_batch_size_misaligns_qcounts_and_unpack_copies_it():
    _, cfg = configs(CASES["odd-batch_hll-flat-pairs_quant-pp"][0])
    assert section_offsets(cfg)["qcounts"] % 8  # the case the copy-before-view exists for
    row = packing.pack_batch(as_port(ref_batches(cfg.batch_size)[0]), cfg)
    q = packing.unpack_device(torch.from_numpy(row), cfg)["qcounts"]
    assert q.dtype == torch.int64 and int(q.sum()) > 0


def test_pack_rejects_what_the_layout_cannot_carry():
    _, cfg = configs(dict(alive_bitmap_bits=20))
    batch = as_port(ref_batches(cfg.batch_size)[0])
    bad = RecordBatch(**{**batch.as_dict(), "partition": batch.partition + 4})
    with pytest.raises(ValueError, match="num_partitions"):
        packing.pack_batch(bad, cfg)
    gap = RecordBatch(**{**batch.as_dict(), "valid": np.arange(len(batch)) % 2 == 0})
    with pytest.raises(ValueError, match="prefix-valid"):
        packing.pack_batch(gap, cfg)


def test_v4_odd_batch_misaligns_ts_minmax_and_unpack_copies_it():
    """The v4 columns take 9 B/record, so ``ts_minmax`` is 8-byte aligned
    only when 9·B is: at B = 1001 it is not, and long keys (u16 past
    32 KiB, negative as int16) must still unpack to their u16 value."""
    ref_cfg, cfg = configs(CASES["v4_odd-batch_hll-u16-pairs"][0])
    assert section_offsets(cfg)["ts_minmax"] % 8
    batch = as_port(ref_batches(cfg.batch_size)[0])
    batch.key_len[:50] = np.where(batch.key_null[:50], 0, 65535)
    batch.key_len[50:60] = np.where(batch.key_null[50:60], 0, 40000)
    row = packing.pack_batch(batch, cfg)
    got = packing.unpack_device(torch.from_numpy(row), cfg)
    want = ref_packing.unpack_numpy(row, ref_cfg)
    np.testing.assert_array_equal(got["key_len"].numpy(), want["key_len"])
    assert int(got["key_len"].max()) == 65535
    np.testing.assert_array_equal(got["ts_min"].numpy(), want["ts_min"])
    assert got["ts_min"].dtype == torch.int64


@pytest.mark.parametrize("wire_format, pallas, rejected", [
    (4, True, True), (4, False, False), (5, True, False),
])
def test_value_cap_applies_to_pallas_v4_only_like_the_reference(
    wire_format, pallas, rejected
):
    kw = dict(wire_format=wire_format, use_pallas_counters=pallas,
              alive_bitmap_bits=20)
    ref_cfg, cfg = configs(kw)
    batch = ref_batches(cfg.batch_size)[0]
    batch.value_len[7] = packing.MAX_VALUE_LEN + 1
    if rejected:
        for pack, args in ((packing.pack_batch, (as_port(batch), cfg)),
                           (ref_packing.pack_batch, (batch, ref_cfg))):
            with pytest.raises(ValueError, match="exceeds the Pallas counter kernel"):
                pack(*args)
    else:
        assert packing.pack_batch(as_port(batch), cfg).tobytes() == \
            ref_packing.pack_batch(batch, ref_cfg, use_native=False).tobytes()
