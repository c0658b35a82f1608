"""The property tier held against the port: one hypothesis twin of each
of ``tests/test_properties.py``'s properties, with the reference's
strategies and ``max_examples``, against the port's ``io/kafka_codec``,
``io/compression``, ``packing`` and ``io/native``.

- Parity: arbitrary record streams through four backends, the port's
  torch backend on the host (its kernels' plain versions) and its numpy
  oracle, the reference's JAX device backend on JAX's CPU and its
  oracle; every exact metric agrees.  A second parity property turns on
  HLL and per-partition size quantiles: the port's HLL registers and
  DDSketch counts equal the reference's exactly (both are functions of
  the hashes and sizes alone), and so do their estimates; the two
  oracles' exact distinct counts and quantiles agree.
- Roundtrips through the port's own encoders (``encode_record_batch``,
  ``encode_control_batch``, ``ByteWriter``), and one more property: a
  batch encoded by either package decodes to the same records through
  the other.
- Totality: the port's record-batch decoder, record-body parser,
  decompressors and response decoders raise only their classified
  errors on garbage; its native record-set walk never over-reads and
  agrees with the port's Python frame iterator on the prefix it accepts.
"""

import zlib

import jax
import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from kafka_topic_analyzer_tpu import checkpoint as ref_checkpoint  # noqa: E402
from kafka_topic_analyzer_tpu.backends.cpu import CpuExactBackend as RefCpuBackend  # noqa: E402
from kafka_topic_analyzer_tpu.backends.tpu import TpuBackend  # noqa: E402
from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefConfig  # noqa: E402
from kafka_topic_analyzer_tpu.io import kafka_codec as ref_kc  # noqa: E402
from kafka_topic_analyzer_tpu.records import RecordBatch as RefBatch  # noqa: E402
from kafka_topic_analyzer_tpu_torch.backends.cpu import CpuExactBackend  # noqa: E402
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend  # noqa: E402
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig  # noqa: E402
from kafka_topic_analyzer_tpu_torch.io import compression as comp  # noqa: E402
from kafka_topic_analyzer_tpu_torch.io import kafka_codec as kc  # noqa: E402
from kafka_topic_analyzer_tpu_torch.io import native  # noqa: E402
from kafka_topic_analyzer_tpu_torch.packing import dedupe_slots_numpy  # noqa: E402
from kafka_topic_analyzer_tpu_torch.records import RecordBatch  # noqa: E402

P = 3
NOW = 10**10

record = st.tuples(
    st.integers(0, P - 1),                       # partition
    st.one_of(st.none(), st.integers(0, 300)),   # key_len (None = null key)
    st.one_of(st.none(), st.integers(0, 5000)),  # value_len (None = tombstone)
    st.integers(-1, 2**33),                      # ts seconds (incl. epoch edge)
    st.integers(0, 2**32 - 1),                   # key hash32
)

kafka_record = st.tuples(
    st.integers(0, 2**40),                      # ts_ms
    st.one_of(st.none(), st.binary(max_size=40)),
    st.one_of(st.none(), st.binary(max_size=200)),
)

ROUNDTRIP_CODECS = [kc.COMPRESSION_NONE, kc.COMPRESSION_GZIP,
                    kc.COMPRESSION_SNAPPY, kc.COMPRESSION_LZ4]


def batch_from(cls, rows):
    """The reference's ``_batch_from``, into either package's batch."""
    b = cls.empty(len(rows))
    for i, (p, kl, vl, ts, h32) in enumerate(rows):
        b.partition[i] = p
        b.key_null[i] = kl is None
        b.key_len[i] = 0 if kl is None else kl
        b.value_null[i] = vl is None
        b.value_len[i] = 0 if vl is None else vl
        b.ts_s[i] = ts
        b.key_hash32[i] = h32
        b.key_hash64[i] = h32 * 2654435761 % 2**64
        b.valid[i] = True
    return b


def fold_everywhere(rows, nbatches, features):
    """Finalized metrics of the four backends, fed the same 64-record
    sub-batches, and the two device backends' state leaves."""
    kw = dict(num_partitions=P, batch_size=64, count_alive_keys=True,
              alive_bitmap_bits=16, **features)
    backends = {
        "port": TorchBackend(AnalyzerConfig(**kw), init_now_s=NOW, device="cpu"),
        "port oracle": CpuExactBackend(AnalyzerConfig(**kw), init_now_s=NOW),
        "reference": TpuBackend(RefConfig(**kw), init_now_s=NOW),
        "reference oracle": RefCpuBackend(RefConfig(**kw), init_now_s=NOW),
    }
    for chunk in np.array_split(np.arange(len(rows)), nbatches):
        if len(chunk) == 0:
            continue
        part = [rows[i] for i in chunk]
        batches = {RecordBatch: batch_from(RecordBatch, part),
                   RefBatch: batch_from(RefBatch, part)}
        for lo in range(0, len(chunk), 64):
            idx = np.arange(lo, min(lo + 64, len(chunk)))
            for name, backend in backends.items():
                cls = RefBatch if name.startswith("reference") else RecordBatch
                backend.update(batches[cls].take(idx))
    flat = ref_checkpoint._flatten(jax.tree.map(
        np.asarray, jax.device_get(backends["reference"].get_state())))
    states = {"port": backends["port"].get_state(),
              "reference": {k[len("state."):]: v for k, v in flat.items()}}
    return {name: b.finalize() for name, b in backends.items()}, states


def assert_exact_parity(metrics: dict) -> None:
    a = metrics["reference oracle"]
    for name, b in metrics.items():
        assert np.array_equal(a.per_partition, b.per_partition), name
        assert a.earliest_ts_s == b.earliest_ts_s, name
        assert a.latest_ts_s == b.latest_ts_s, name
        assert a.smallest_message == b.smallest_message, name
        assert a.largest_message == b.largest_message, name
        assert a.alive_keys == b.alive_keys, name
        assert np.array_equal(a.per_partition_extremes, b.per_partition_extremes), name


def assert_same_quantiles(got, want) -> None:
    """Equal summaries (NaN where a partition has no sizes), or none in
    either (an oracle that saw no sized record)."""
    assert (got.quantiles is None) == (want.quantiles is None)
    if want.quantiles is None:
        return
    for a, b in ((got.quantiles, want.quantiles),
                 *zip(got.quantiles_per_partition, want.quantiles_per_partition,
                      strict=True)):
        np.testing.assert_array_equal(a.values, b.values)


@settings(max_examples=30, deadline=None)
@given(st.lists(record, min_size=1, max_size=200), st.integers(1, 4))
def test_four_backend_parity_arbitrary_streams(rows, nbatches):
    metrics, _ = fold_everywhere(rows, nbatches, {})
    assert_exact_parity(metrics)


@settings(max_examples=30, deadline=None)
@given(st.lists(record, min_size=1, max_size=200), st.integers(1, 4))
def test_four_backend_parity_with_hll_and_quantiles(rows, nbatches):
    metrics, states = fold_everywhere(rows, nbatches, dict(
        enable_hll=True, hll_p=12, enable_quantiles=True,
        quantiles_per_partition=True))
    assert_exact_parity(metrics)
    port, ref = states["port"], states["reference"]
    assert np.array_equal(port["hll.regs"], ref["hll.regs"])
    assert np.array_equal(port["quantiles.counts"], ref["quantiles.counts"])
    dev, ref_dev = metrics["port"], metrics["reference"]
    assert dev.distinct_keys_hll == ref_dev.distinct_keys_hll
    assert_same_quantiles(dev, ref_dev)
    exact, ref_exact = metrics["port oracle"], metrics["reference oracle"]
    assert exact.distinct_keys_exact == ref_exact.distinct_keys_exact
    assert_same_quantiles(exact, ref_exact)


@settings(max_examples=50, deadline=None)
@given(st.lists(st.integers(-(2**62), 2**62), max_size=30))
def test_varint_roundtrip_property(values):
    w = kc.ByteWriter()
    for v in values:
        w.varint(v)
    r = kc.ByteReader(w.done())
    assert [r.varint() for _ in values] == values


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**40), st.lists(kafka_record, min_size=1, max_size=30),
       st.sampled_from(ROUNDTRIP_CODECS))
def test_record_batch_roundtrip_property(base, recs, codec):
    rows = [(base + 2 * i, ts, k, v) for i, (ts, k, v) in enumerate(recs)]
    buf = kc.encode_record_batch(rows, codec)
    got = [(off, ts, k, v)
           for off, (ts, k, v) in kc.decode_record_batches(buf, verify_crc=True)]
    assert got == rows


def frames(codec_module, buf: bytes) -> list:
    return [(f.base_offset, f.num_records, f.end_offset, f.byte_start, f.byte_end)
            for f in codec_module.iter_batch_frames(buf, verify_crc=True)]


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**40), st.lists(kafka_record, min_size=1, max_size=30),
       st.sampled_from(ROUNDTRIP_CODECS), st.booleans())
def test_record_batch_decodes_the_same_across_packages(base, recs, codec, with_control):
    """A batch (and a trailing control batch) encoded by one package
    decodes to the same records through the other, both ways."""
    rows = [(base + 2 * i, ts, k, v) for i, (ts, k, v) in enumerate(recs)]
    end = rows[-1][0] + 1
    for encoder, decoder in ((ref_kc, kc), (kc, ref_kc)):
        buf = encoder.encode_record_batch(rows, codec)
        if with_control:
            buf += encoder.encode_control_batch(end, 1000)
        got = [(off, ts, k, v)
               for off, (ts, k, v) in decoder.decode_record_batches(buf, verify_crc=True)]
        assert got == rows
        assert frames(decoder, buf) == frames(encoder, buf)


@settings(max_examples=200, deadline=None)
@given(st.binary(max_size=400), st.booleans())
def test_record_batch_decoder_total_on_garbage(buf, verify_crc):
    try:
        list(kc.decode_record_batches(buf, verify_crc=verify_crc))
    except kc.KafkaProtocolError:
        pass


@settings(max_examples=150, deadline=None)
@given(st.lists(kafka_record, min_size=1, max_size=5), st.integers(0, 60),
       st.integers(1, 255))
def test_record_body_parser_total_on_mutated_batches(recs, mpos, mask):
    rows = [(i, ts, k, v) for i, (ts, k, v) in enumerate(recs)]
    buf = bytearray(kc.encode_record_batch(rows))
    body_start = 61  # fixed v2 batch header size
    if len(buf) > body_start:
        buf[body_start + mpos % (len(buf) - body_start)] ^= mask
    try:
        list(kc.decode_record_batches(bytes(buf), verify_crc=False))
    except kc.KafkaProtocolError:
        pass


@settings(max_examples=150, deadline=None)
@given(st.sampled_from([b"", b"\x82SNAPPY\x00", b"\x04\x22\x4d\x18"]),
       st.binary(max_size=300), st.sampled_from([1, 2, 3]))
def test_decompressors_total_on_garbage(prefix, data, codec):
    payload = prefix + data
    try:
        comp.decompress(codec, payload)
    except (ValueError, zlib.error):
        pass
    for py_decoder in (comp.snappy_decompress_py, comp.lz4_decompress_py):
        try:
            py_decoder(payload)
        except ValueError:
            pass


@settings(max_examples=150, deadline=None)
@given(st.binary(max_size=200))
def test_response_decoders_total_on_garbage(buf):
    for decoder in (kc.decode_metadata_response, kc.decode_list_offsets_response,
                    kc.decode_fetch_response, kc.decode_api_versions_response,
                    kc.decode_offset_for_leader_epoch_response):
        for version in (1, 4, 7, 12):
            try:
                decoder(kc.ByteReader(buf), version)
            except kc.KafkaProtocolError:
                pass
            except MemoryError:
                raise AssertionError("decoder allocated unbounded memory")


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 2**63 - 1), max_size=8),
       st.lists(st.one_of(st.none(), st.text(max_size=40)), max_size=5),
       st.lists(st.one_of(st.none(), st.binary(max_size=64)), max_size=5))
def test_flexible_primitives_roundtrip_property(uints, strings, blobs):
    w = kc.ByteWriter()
    for v in uints:
        w.uvarint(v)
    for s in strings:
        w.compact_string(s)
    for b in blobs:
        w.compact_bytes(b)
    r = kc.ByteReader(w.done())
    assert [r.uvarint() for _ in uints] == uints
    assert [r.compact_string() for _ in strings] == strings
    assert [r.compact_bytes() for _ in blobs] == blobs
    assert r.remaining() == 0


@settings(max_examples=150, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 2**31 - 1), st.binary(max_size=32)),
                max_size=6),
       st.binary(max_size=32))
def test_skip_tags_skips_arbitrary_tag_buffers(tag_fields, tail):
    w = kc.ByteWriter()
    w.uvarint(len(tag_fields))
    for tag, data in tag_fields:
        w.uvarint(tag).uvarint(len(data)).raw(data)
    w.raw(tail)
    r = kc.ByteReader(w.done())
    r.skip_tags()
    assert bytes(r._take(r.remaining())) == tail


def test_invalid_utf8_string_is_protocol_error():
    w = kc.ByteWriter()
    w.i32(1).i32(0)            # one broker, node_id 0
    w.i16(2).raw(b"\xff\xfe")  # host: invalid UTF-8
    w.i32(9092).string(None)   # port, rack
    w.i32(0).i32(0)            # controller, topics
    with pytest.raises(kc.KafkaProtocolError, match="UTF-8"):
        kc.decode_metadata_response(kc.ByteReader(w.done()))


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 255), st.booleans(), st.booleans()),
                min_size=1, max_size=300))
def test_dedupe_matches_sequential_replay(updates):
    """The port's numpy and native dedupe against a literal insert/remove
    replay of the reference tool's alive-key handling."""
    h32 = np.array([u[0] for u in updates], dtype=np.uint32)
    active = np.array([u[1] for u in updates], dtype=bool)
    alive = np.array([u[2] for u in updates], dtype=bool)
    replay = {}
    for h, act, al in updates:
        if act:
            replay[h & 0xFF] = al
    want = {k: int(v) for k, v in replay.items()}
    for dedupe in (dedupe_slots_numpy, native.dedupe_slots_native):
        slots, flags = dedupe(h32, active, alive, bits=8)
        assert dict(zip(slots.tolist(), flags.tolist())) == want
        assert len(slots) == len(want)


@settings(max_examples=200, deadline=None)
@given(st.lists(kafka_record, min_size=0, max_size=4), st.integers(0, 200),
       st.integers(0, 255), st.integers(0, 80), st.booleans())
def test_native_record_set_walk_total_and_prefix_consistent(
        recs, mpos, mask, cut, with_control):
    assert native.native_available(), native.native_status()
    rows = [(i, ts, k, v) for i, (ts, k, v) in enumerate(recs)]
    buf = bytearray()
    if rows:
        buf += kc.encode_record_batch(rows)
    if with_control:
        buf += kc.encode_control_batch(len(rows), 1000)
    if mask and buf:
        buf[mpos % len(buf)] ^= mask
    if cut:
        buf = buf[: max(0, len(buf) - cut)]
    data = bytes(buf)

    n, consumed, covered = native.scan_record_set_native(data)
    soa, used, covered2 = native.decode_record_set_native(data)
    assert 0 <= consumed <= len(data)
    if used:
        assert (used, covered2) == (consumed, covered)
        assert len(soa["offsets"]) == n
        py_offsets = [off for f in kc.iter_batch_frames(data[:consumed])
                      for off, _ in kc.decode_frame_records(f)]
        assert soa["offsets"].tolist() == py_offsets
