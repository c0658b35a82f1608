"""The port's segment files and store against the reference's.

The port writes the reference writer's bytes, each package reads the
other's dumps (gapless and gappy, with the offsets column), damaged dumps
are classified as the reference classifies them (bad magic, truncated
header and payload, impossible header, header/file-name mismatch,
overlapping chunks, a topic whose name extends another's), and remote
store specs are refused rather than read as something else.
"""

import os
import shutil

import numpy as np
import pytest

from kafka_topic_analyzer_tpu.io import segfile as ref_segfile
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSource as RefSource
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSpec as RefSpec
from kafka_topic_analyzer_tpu.records import RecordBatch as RefBatch
from kafka_topic_analyzer_tpu_torch.io import segfile, segstore
from kafka_topic_analyzer_tpu_torch.io.kafka_codec import CorruptFrameError
from kafka_topic_analyzer_tpu_torch.io.segfile import (
    MalformedSegmentError,
    SegmentFile,
    SegmentFileSource,
    TruncatedSegmentError,
    write_segment_from_batches,
)
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.records import RecordBatch
from kafka_topic_analyzer_tpu_torch.tools import make_segments

SPEC = dict(num_partitions=3, messages_per_partition=2_500, keys_per_partition=100,
            tombstone_permille=120, seed=5)


@pytest.fixture()
def seg_dir(tmp_path):
    src = SyntheticSource(SyntheticSpec(**SPEC))
    for p in src.partitions():
        write_segment_from_batches(
            str(tmp_path), "t", p, list(src.batches(1000, partitions=[p]))
        )
    return str(tmp_path)


def gappy_columns(seed: int, n: int):
    """One partition's columns with negative and sub-second timestamps,
    and gappy offsets."""
    rng = np.random.default_rng(seed)
    key_null = rng.random(n) < 0.1
    cols = {
        "key_len": np.where(key_null, 0, rng.integers(1, 30, n)).astype(np.int32),
        "value_len": rng.integers(0, 900, n).astype(np.int32),
        "key_null": key_null.astype(np.uint8),
        "value_null": (rng.random(n) < 0.2).astype(np.uint8),
        "ts_ms": rng.integers(-5_000_000, 5_000_000, n),
        "key_hash32": rng.integers(0, 2**32, n, dtype=np.uint32),
        "key_hash64": rng.integers(0, 2**64, n, dtype=np.uint64),
    }
    offsets = np.cumsum(rng.integers(1, 4, n)).astype(np.int64) + 40
    return cols, offsets


def test_roundtrip_header_watermarks_and_catalog(seg_dir):
    src = SegmentFileSource(seg_dir, "t")
    assert src.partitions() == [0, 1, 2]
    assert src.watermarks() == ({0: 0, 1: 0, 2: 0}, {0: 2500, 1: 2500, 2: 2500})
    assert src.partition_record_counts() == {0: 2500, 1: 2500, 2: 2500}
    seg = SegmentFile(f"{seg_dir}/t-0.ktaseg")
    assert (seg.count, seg.partition, seg.has_offsets) == (2500, 0, False)
    store = segstore.open_segment_store(f"file://{seg_dir}")
    assert isinstance(store, segstore.DirectorySegmentStore)
    catalog = segstore.SegmentCatalog(store, "t")
    assert catalog.num_files == 3
    assert catalog.total_bytes == sum(r.size for r in store.list_refs("t"))


def test_write_segment_bytes_equal_the_reference_writer(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    cols, offsets = gappy_columns(1, 777)
    segfile.write_segment(str(tmp_path / "port" / "g-2.ktaseg"), 2, 40, cols, offsets)
    ref_segfile.write_segment(str(tmp_path / "ref" / "g-2.ktaseg"), 2, 40, cols, offsets)
    batches = list(SyntheticSource(SyntheticSpec(**SPEC)).batches(600, partitions=[1]))
    ref_batches = list(RefSource(RefSpec(**SPEC)).batches(600, partitions=[1]))
    write_segment_from_batches(str(tmp_path / "port"), "t", 1, batches, start_offset=9)
    ref_segfile.write_segment_from_batches(
        str(tmp_path / "ref"), "t", 1, ref_batches, start_offset=9)
    for name in ("g-2.ktaseg", "t-1.ktaseg"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name
    make_segments.main(["--out", str(tmp_path / "mk"), "--topic", "t", "--synthetic",
                        "partitions=3,messages=2500,keys=100,tombstones=120,seed=5"])
    for p in range(3):
        ref_segfile.write_segment_from_batches(
            str(tmp_path / "ref"), "t", p,
            list(RefSource(RefSpec(**SPEC)).batches(1 << 20, partitions=[p])))
        assert (tmp_path / "mk" / f"t-{p}.ktaseg").read_bytes() == \
            (tmp_path / "ref" / f"t-{p}.ktaseg").read_bytes()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_dumps(tmp_path, writer):
    """Gapless and gappy dumps (the offsets column), whole and resumed
    mid-chunk, read by both readers to the same batches."""
    write = segfile.write_segment if writer == "port" else ref_segfile.write_segment
    cols, offsets = gappy_columns(2, 1500)
    write(str(tmp_path / "d-0.c0.ktaseg"), 0, int(offsets[0]),
          {k: v[:900] for k, v in cols.items()}, offsets[:900])
    write(str(tmp_path / "d-0.c1.ktaseg"), 0, int(offsets[900]),
          {k: v[900:] for k, v in cols.items()}, offsets[900:])
    write(str(tmp_path / "d-4.ktaseg"), 4, 7, {k: v[:333] for k, v in cols.items()})
    port, ref = SegmentFileSource(str(tmp_path), "d"), ref_segfile.SegmentFileSource(
        str(tmp_path), "d")
    assert port.watermarks() == ref.watermarks() == (
        {0: int(offsets[0]), 4: 7}, {0: int(offsets[-1]) + 1, 4: 340})
    for start_at in (None, {0: int(offsets[1000]) - 1, 4: 100}):
        got = RecordBatch.concat(list(port.batches(256, start_at=start_at)))
        want = RefBatch.concat(list(ref.batches(256, start_at=start_at)))
        for name, _ in RecordBatch.FIELDS:
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), name)
        assert got.offsets is None and want.offsets is None  # one chunk lacks them
    gappy = RecordBatch.concat(list(port.batches(256, partitions=[0])))
    np.testing.assert_array_equal(gappy.offsets, offsets)
    np.testing.assert_array_equal(gappy.ts_s, cols["ts_ms"] // 1000)


def test_read_batch_is_zero_copy_and_matches_copy(seg_dir):
    seg = SegmentFile(f"{seg_dir}/t-0.ktaseg")
    view = seg.read_batch(100, 400)
    deep = seg.read_batch(100, 400, copy=True)
    for name, _ in view.FIELDS:
        assert np.array_equal(getattr(view, name), getattr(deep, name)), name
        assert not np.shares_memory(getattr(deep, name), seg._mm), name
    for name in ("key_len", "value_len", "key_null", "value_null",
                 "key_hash32", "key_hash64"):
        assert np.shares_memory(getattr(view, name), seg._mm), name
        assert not getattr(view, name).flags.writeable, name


def test_corrupt_magic_rejected(seg_dir, tmp_path):
    bad = tmp_path / "t-9.ktaseg"
    data = bytearray(open(f"{seg_dir}/t-0.ktaseg", "rb").read())
    data[:8] = b"NOTASEG!"
    bad.write_bytes(bytes(data))
    with pytest.raises(MalformedSegmentError, match="bad magic") as e:
        SegmentFile(str(bad))
    assert isinstance(e.value, ValueError) and isinstance(e.value, CorruptFrameError)
    assert (e.value.kind, e.value.path, e.value.span) == ("malformed-header", str(bad), (0, 8))


def test_truncated_header_classified(tmp_path):
    bad = tmp_path / "t-0.ktaseg"
    bad.write_bytes(b"KTASEG01\x00\x00")  # 10 of 28 header bytes
    with pytest.raises(TruncatedSegmentError, match="truncated header") as e:
        SegmentFile(str(bad))
    assert (e.value.kind, e.value.path) == ("truncated", str(bad))
    assert isinstance(e.value, CorruptFrameError)


def test_truncated_payload_classified(seg_dir, tmp_path):
    data = open(f"{seg_dir}/t-0.ktaseg", "rb").read()
    bad = tmp_path / "t-0.ktaseg"
    bad.write_bytes(data[:-100])
    with pytest.raises(TruncatedSegmentError, match="size") as e:
        SegmentFile(str(bad))
    assert (e.value.kind, e.value.partition, e.value.num_records) == ("truncated", 0, 2500)
    bad.write_bytes(data + b"xx")  # trailing garbage is malformed
    with pytest.raises(MalformedSegmentError, match="size"):
        SegmentFile(str(bad))


def test_impossible_header_classified(tmp_path):
    bad = tmp_path / "t-0.ktaseg"
    bad.write_bytes(segfile._HEADER.pack(b"KTASEG01", 0, 0, 0, -5))
    with pytest.raises(MalformedSegmentError, match="impossible header"):
        SegmentFile(str(bad))


def test_filename_header_mismatch_classified(seg_dir, tmp_path):
    shutil.copy(f"{seg_dir}/t-0.ktaseg", tmp_path / "t-7.ktaseg")
    with pytest.raises(MalformedSegmentError, match="does not match filename"):
        SegmentFileSource(str(tmp_path), "t")


def test_overlapping_chunks_classified(seg_dir, tmp_path):
    shutil.copy(f"{seg_dir}/t-0.ktaseg", tmp_path / "t-0.c0.ktaseg")
    shutil.copy(f"{seg_dir}/t-0.ktaseg", tmp_path / "t-0.c1.ktaseg")
    with pytest.raises(MalformedSegmentError, match="overlapping"):
        SegmentFileSource(str(tmp_path), "t")


def test_topic_name_prefix_not_confused(seg_dir):
    src0 = SyntheticSource(SyntheticSpec(**SPEC))
    write_segment_from_batches(seg_dir, "t-extra", 0,
                               list(src0.batches(1000, partitions=[0])))
    src = SegmentFileSource(seg_dir, "t")
    assert src.partitions() == [0, 1, 2]
    assert src.watermarks()[1][0] == 2500
    assert sorted(os.listdir(seg_dir))[-1] == "t-extra-0.ktaseg"


@pytest.mark.parametrize(
    "spec, match",
    [("http://127.0.0.1:1/bucket", "remote segment stores are not yet ported"),
     ("https://host/bucket/prefix", "remote segment stores are not yet ported"),
     ("s3://bucket/prefix", "remote segment stores are not yet ported"),
     ("gs://bucket", "scheme 'gs' is not supported")],
)
def test_remote_and_unknown_store_specs_are_refused(spec, match):
    with pytest.raises(ValueError, match=match):
        segstore.open_segment_store(spec)
    with pytest.raises(ValueError, match=match):
        SegmentFileSource(spec, "t")


def test_missing_directory_refused_and_file_url_accepted(tmp_path):
    with pytest.raises(ValueError, match="not a directory"):
        segstore.open_segment_store(str(tmp_path / "missing"))
    assert segstore.open_segment_store(f"file://{tmp_path}").list_refs("t") == []
