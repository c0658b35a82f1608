"""The port's Kafka codec, compression codecs and zstd decoder against the
reference's.

Seeded requests and responses encode to the same bytes in both packages at
every negotiated version (classic and flexible) and decode to the same
values across them; record batches in all five compressions, legacy
message sets (magic 0 and 1), control batches, and frames damaged by
seeded byte flips and truncations parse to the same frames, the same
salvage spans and the same error kinds and messages; CRC32-C agrees with
the reference's and with the table loop; each compression codec
round-trips across the two packages.  All comparisons are exact.
"""

import dataclasses
import pathlib

import numpy as np
import pytest

from kafka_topic_analyzer_tpu.io import compression as ref_comp
from kafka_topic_analyzer_tpu.io import kafka_codec as ref_kc
from kafka_topic_analyzer_tpu.io import zstd_py as ref_zstd
from kafka_topic_analyzer_tpu_torch import _build
from kafka_topic_analyzer_tpu_torch.io import compression as comp
from kafka_topic_analyzer_tpu_torch.io import kafka_codec as kc
from kafka_topic_analyzer_tpu_torch.io import native
from kafka_topic_analyzer_tpu_torch.io import zstd_py

ROOT = pathlib.Path(__file__).resolve().parent.parent
CODECS = [kc.COMPRESSION_NONE, kc.COMPRESSION_GZIP, kc.COMPRESSION_SNAPPY,
          kc.COMPRESSION_LZ4, kc.COMPRESSION_ZSTD]


def records(seed: int, n: int, base: int = 0, gaps: bool = False):
    """(offset, ts_ms, key, value) with null keys, tombstones, empty and
    long values, and (with ``gaps``) compaction holes in the offsets."""
    rng = np.random.default_rng(seed)
    out, off = [], base
    for _ in range(n):
        key = None if rng.random() < 0.1 else rng.bytes(int(rng.integers(0, 40)))
        value = None if rng.random() < 0.1 else rng.bytes(int(rng.integers(0, 600)))
        out.append((off, 1_700_000_000_000 + int(rng.integers(-5000, 5000)), key, value))
        off += int(rng.integers(1, 4)) if gaps else 1
    return out


def both(fn_name: str, *args, **kw):
    """``fn_name`` of each codec on the same arguments: (port, reference)."""
    return getattr(kc, fn_name)(*args, **kw), getattr(ref_kc, fn_name)(*args, **kw)


# -- requests and responses -------------------------------------------------

API_VERSIONS = [  # (api, versions): classic and flexible encodings
    (kc.API_METADATA, [1, 5, 9, 10, 12]),
    (kc.API_LIST_OFFSETS, [1, 4, 6, 7]),
    (kc.API_FETCH, [4, 9, 11, 12]),
    (kc.API_VERSIONS, [0, 3]),
    (kc.API_OFFSET_FOR_LEADER_EPOCH, [2, 3, 4]),
]
CASES = [(api, v) for api, vs in API_VERSIONS for v in vs]


@pytest.mark.parametrize("api,version", CASES, ids=lambda x: str(x))
def test_requests_encode_to_the_references_bytes(api, version):
    rng = np.random.default_rng(api * 100 + version)
    parts = [int(p) for p in rng.choice(64, 5, replace=False)]
    if api == kc.API_METADATA:
        body = both("encode_metadata_request", ["orders", "t.x"], version=version)
        assert body[0] == body[1]
        assert both("encode_metadata_request", None, version=version)[0] == \
            ref_kc.encode_metadata_request(None, version=version)
        got = kc.decode_metadata_request(kc.ByteReader(body[1]), version=version)
        assert got == ref_kc.decode_metadata_request(ref_kc.ByteReader(body[0]), version=version)
    elif api == kc.API_LIST_OFFSETS:
        pts = [(p, int(rng.integers(-2, 2**40))) for p in parts]
        body = both("encode_list_offsets_request", "orders", pts, version=version)
        assert body[0] == body[1]
        assert kc.decode_list_offsets_request(kc.ByteReader(body[1]), version=version) == \
            ref_kc.decode_list_offsets_request(ref_kc.ByteReader(body[0]), version=version)
    elif api == kc.API_FETCH:
        pos = [(p, int(rng.integers(0, 2**40)), int(rng.integers(-1, 9))) for p in parts]
        body = both("encode_fetch_request", "orders", pos, 500, 1, 52428800,
                    1048576, version=version)
        assert body[0] == body[1]
        assert kc.decode_fetch_request(kc.ByteReader(body[1]), version=version) == \
            ref_kc.decode_fetch_request(ref_kc.ByteReader(body[0]), version=version)
    elif api == kc.API_VERSIONS:
        body = both("encode_api_versions_request", version)
        assert body[0] == body[1]
    else:
        req = [(p, int(rng.integers(-1, 9)), int(rng.integers(0, 9))) for p in parts]
        body = both("encode_offset_for_leader_epoch_request", "orders", req, version=version)
        assert body[0] == body[1]
        assert kc.decode_offset_for_leader_epoch_request(kc.ByteReader(body[1]), version=version) \
            == ref_kc.decode_offset_for_leader_epoch_request(
                ref_kc.ByteReader(body[0]), version=version)
    framed = both("encode_request", api, version, 7, "topic-analyzer", body[0])
    assert framed[0] == framed[1]
    head = kc.decode_request_header(framed[0][4:])
    ref_head = ref_kc.decode_request_header(framed[1][4:])
    assert head[:4] == ref_head[:4] == (api, version, 7, "topic-analyzer")
    assert head[4].pos == ref_head[4].pos


def _metadata(mod, rng, version):
    brokers = {int(n): (f"h{n}.example", int(9090 + n)) for n in rng.choice(9, 3, replace=False)}
    topics = [
        mod.TopicMetadata(
            int(rng.integers(0, 2)) * 3, name,
            [mod.PartitionMetadata(0, p, int(rng.choice(list(brokers))))
             for p in range(int(rng.integers(1, 6)))],
            is_internal=int(name.startswith("__")),
        )
        for name in ("orders", "__consumer_offsets")
    ]
    return mod.MetadataResponse(brokers, int(next(iter(brokers))), topics)


@pytest.mark.parametrize("api,version", CASES, ids=lambda x: str(x))
def test_responses_encode_to_the_references_bytes_and_decode_across(api, version):
    seed = api * 1000 + version

    def fields(x):
        if isinstance(x, memoryview):
            return bytes(x)
        if isinstance(x, list):
            return [fields(v) for v in x]
        if not dataclasses.is_dataclass(x):
            return x
        return {f.name: fields(getattr(x, f.name)) for f in dataclasses.fields(x)}

    if api == kc.API_METADATA:
        port = kc.encode_metadata_response(_metadata(kc, np.random.default_rng(seed), version),
                                           version=version)
        ref = ref_kc.encode_metadata_response(
            _metadata(ref_kc, np.random.default_rng(seed), version), version=version)
        dec, ref_dec = kc.decode_metadata_response, ref_kc.decode_metadata_response
    elif api == kc.API_LIST_OFFSETS:
        rng = np.random.default_rng(seed)
        res = [(p, int(rng.choice([0, 1, 6])), -1, int(rng.integers(0, 2**40)),
                int(rng.integers(-1, 5))) for p in range(6)]
        port, ref = both("encode_list_offsets_response", "orders", res, version=version)
        dec, ref_dec = kc.decode_list_offsets_response, ref_kc.decode_list_offsets_response
    elif api == kc.API_FETCH:
        rng = np.random.default_rng(seed)
        parts = [(p, int(rng.choice([0, 1, 74])), int(rng.integers(0, 2**40)),
                  ref_kc.encode_record_batch(records(seed + p, 7, base=100 * p)),
                  int(rng.integers(0, 50))) for p in range(4)]
        port, ref = both("encode_fetch_response", "orders", parts, version=version)
        dec, ref_dec = kc.decode_fetch_response, ref_kc.decode_fetch_response
    elif api == kc.API_VERSIONS:
        apis = [(kc.API_FETCH, 4, 12), (kc.API_METADATA, 1, 12), (kc.API_VERSIONS, 0, 3)]
        port, ref = both("encode_api_versions_response", apis, version=version)
        dec, ref_dec = kc.decode_api_versions_response, ref_kc.decode_api_versions_response
    else:
        rng = np.random.default_rng(seed)
        res = [(p, int(rng.choice([0, 74, 75])), int(rng.integers(-1, 9)),
                int(rng.integers(-1, 2**40))) for p in range(5)]
        port, ref = both("encode_offset_for_leader_epoch_response", "orders", res,
                         version=version)
        dec = kc.decode_offset_for_leader_epoch_response
        ref_dec = ref_kc.decode_offset_for_leader_epoch_response
    assert port == ref
    got = dec(kc.ByteReader(ref), version=version)
    want = ref_dec(ref_kc.ByteReader(port), version=version)
    assert fields(got) == fields(want)


def test_sasl_messages_and_scram_exchanges_across_packages():
    for mod_a, mod_b in ((kc, ref_kc), (ref_kc, kc)):
        for mech in ("PLAIN", "SCRAM-SHA-256"):
            assert mod_a.encode_sasl_handshake_request(mech) == \
                mod_b.encode_sasl_handshake_request(mech)
        resp = mod_a.encode_sasl_handshake_response(0, ["PLAIN", "SCRAM-SHA-512"])
        assert resp == mod_b.encode_sasl_handshake_response(0, ["PLAIN", "SCRAM-SHA-512"])
        assert mod_b.decode_sasl_handshake_response(mod_b.ByteReader(resp)) == \
            (0, ["PLAIN", "SCRAM-SHA-512"])
        tok = mod_a.sasl_plain_token("alice", "s3cr=t,")
        assert tok == mod_b.sasl_plain_token("alice", "s3cr=t,")
        req = mod_a.encode_sasl_authenticate_request(tok)
        assert mod_b.decode_sasl_authenticate_request(mod_b.ByteReader(req)) == tok
        for args in ((0, None, b"ok"), (58, "bad credentials", b"")):
            r = mod_a.encode_sasl_authenticate_response(*args)
            assert r == mod_b.encode_sasl_authenticate_response(*args)
            assert mod_a.decode_sasl_authenticate_response(mod_a.ByteReader(r)) == \
                mod_b.decode_sasl_authenticate_response(mod_b.ByteReader(r))
        # A client of one package against a server of the other.
        for mech in ("SCRAM-SHA-256", "SCRAM-SHA-512"):
            client = mod_a.ScramClient(mech, "al=ice,", "pencil")
            server = mod_b.ScramServer(mech, "al=ice,", "pencil", iterations=4096)
            server_first = server.handle_first(client.first_message())
            ok, server_final = server.handle_final(client.final_message(server_first))
            assert ok
            client.verify_server_final(server_final)
            bad = mod_b.ScramServer(mech, "al=ice,", "other", iterations=4096)
            c2 = mod_a.ScramClient(mech, "al=ice,", "pencil")
            ok, final = bad.handle_final(c2.final_message(bad.handle_first(c2.first_message())))
            assert (ok, final) == (False, b"e=invalid-proof")
            with pytest.raises(mod_a.KafkaProtocolError, match="invalid-proof"):
                c2.verify_server_final(final)


# -- record batches and message sets ----------------------------------------

def frame_fields(frame):
    return (type(frame).__name__, frame.base_offset, frame.first_ts, frame.num_records,
            bytes(frame.payload), frame.end_offset, frame.legacy_records,
            frame.byte_start, frame.byte_end, frame.leader_epoch)


def item_fields(item):
    if hasattr(item, "error"):
        e = item.error
        return ("span", type(e).__name__, e.kind, str(e), e.base_offset, e.span,
                e.claimed_end, e.num_records, e.crc_expected, e.crc_actual,
                item.start, item.end, item.base_offset, item.claimed_end,
                item.resume_offset, item.num_records)
    return frame_fields(item)


def record_set(seed: int, codec: int) -> bytes:
    """Three v2 batches of ``codec`` (one with a compacted tail), a control
    batch and a legacy-free tail."""
    rs = records(seed, 90, base=1000, gaps=True)
    return b"".join([
        ref_kc.encode_record_batch(rs[:30], compression=codec, leader_epoch=3),
        ref_kc.encode_record_batch(rs[30:60], compression=codec,
                                   last_offset=rs[62][0], leader_epoch=3),
        ref_kc.encode_control_batch(rs[62][0] + 1, 1_700_000_000_000),
        ref_kc.encode_record_batch(
            [(o + 10, t, k, v) for o, t, k, v in rs[60:]], compression=codec,
            leader_epoch=4),
    ])


@pytest.mark.parametrize("codec", CODECS)
def test_record_batches_encode_and_decode_as_the_reference(codec):
    rs = records(codec, 50, base=77)
    assert kc.encode_record_batch(rs, compression=codec, leader_epoch=2) == \
        ref_kc.encode_record_batch(rs, compression=codec, leader_epoch=2)
    assert kc.encode_control_batch(5, 9, commit=False) == \
        ref_kc.encode_control_batch(5, 9, commit=False)
    buf = record_set(codec, codec)
    for verify in (False, True):
        got = [frame_fields(f) for f in kc.iter_batch_frames(buf, verify)]
        assert got == [frame_fields(f) for f in ref_kc.iter_batch_frames(buf, verify)]
        assert list(kc.decode_record_batches(buf, verify)) == \
            list(ref_kc.decode_record_batches(buf, verify))
    assert next(kc.decode_record_batches(buf))[0] == 1000


@pytest.mark.parametrize("magic,codec", [(0, 0), (1, 0), (0, 1), (1, 1), (1, 2), (1, 3)])
def test_legacy_message_sets_encode_and_decode_as_the_reference(magic, codec):
    rs = records(10 * magic + codec, 40, base=500, gaps=True)
    for log_append in (False, True):
        enc = kc.encode_message_set(rs, magic=magic, compression=codec,
                                    log_append_time=log_append)
        assert enc == ref_kc.encode_message_set(rs, magic=magic, compression=codec,
                                                log_append_time=log_append)
        assert [frame_fields(f) for f in kc.iter_batch_frames(enc, True)] == \
            [frame_fields(f) for f in ref_kc.iter_batch_frames(enc, True)]
        assert list(kc.decode_record_batches(enc)) == list(ref_kc.decode_record_batches(enc))


def damaged(seed: int):
    """A mixed record set and seeded damage to it: byte flips anywhere
    (header, CRC, payload), flips of a length prefix, and truncations."""
    rng = np.random.default_rng(seed)
    buf = bytearray(record_set(seed, int(rng.choice([0, 0, 2, 3]))))
    buf += ref_kc.encode_message_set(records(seed + 1, 5, base=5000), magic=1)
    kind = seed % 3
    if kind == 0:
        for _ in range(int(rng.integers(1, 4))):
            buf[int(rng.integers(0, len(buf)))] ^= int(rng.integers(1, 256))
    elif kind == 1:
        buf[8 + int(rng.integers(0, 4))] ^= int(rng.integers(1, 256))
    else:
        buf = buf[: int(rng.integers(1, len(buf)))]
    return bytes(buf)


def outcome(mod, fn, buf, verify):
    """The items ``fn`` yields, then the error it raises (class, kind,
    message, context) or None."""
    items = []
    try:
        for item in getattr(mod, fn)(buf, verify):
            items.append(item_fields(item) if fn != "decode_record_batches" else item)
    except mod.KafkaProtocolError as e:
        return items, (type(e).__name__, getattr(e, "kind", None), str(e),
                       getattr(e, "span", None), getattr(e, "base_offset", None))
    return items, None


@pytest.mark.parametrize("seed", range(24))
def test_damaged_frames_salvage_and_classify_as_the_reference(seed):
    buf = damaged(seed)
    for verify in (False, True):
        for fn in ("salvage_batch_frames", "iter_batch_frames", "decode_record_batches"):
            assert outcome(kc, fn, buf, verify) == outcome(ref_kc, fn, buf, verify), fn


def test_native_frame_decoder_matches_the_python_decoder():
    buf = record_set(3, kc.COMPRESSION_NONE)
    for frame in kc.iter_batch_frames(buf, True):
        soa = native.decode_records_native(frame)
        py = list(kc.decode_frame_records(frame))
        if not py:
            continue
        assert soa["offsets"].tolist() == [o for o, _ in py]
        assert soa["ts_ms"].tolist() == [r[0] for _, r in py]
        assert soa["key_null"].tolist() == [int(r[1] is None) for _, r in py]
        assert soa["value_len"].tolist() == [len(r[2] or b"") for _, r in py]
    n, used, covered = native.scan_record_set_native(buf, True)
    soa, used2, covered2 = native.decode_record_set_native(buf, True)
    assert (used, covered) == (used2, covered2) and len(soa["offsets"]) == n
    assert n == sum(1 for _ in kc.decode_record_batches(buf))


# -- CRC32-C and the native library -----------------------------------------

def test_crc32c_agrees_and_comes_from_the_ports_shim():
    rng = np.random.default_rng(4)
    for n in (0, 1, 7, 64, 1000, 65537):
        data = rng.bytes(n)
        want = ref_kc._crc32c_py(data)
        assert kc._crc32c(data) == ref_kc._crc32c(data) == kc._crc32c_py(data) == want
        assert kc._crc32c(bytearray(data)) == want
        assert native.crc32c_native(memoryview(data)) == want
    assert kc._crc32c(b"123456789") == 0xE3069283  # the check value of CRC-32C
    assert kc._crc32c_impl is native.crc32c_native
    lib = native.load_library()
    assert lib._name == str(_build.native_library_path())
    assert pathlib.Path(lib._name).name.startswith("libkta_ingest_torch-")
    for name in ("kafka_codec.py", "compression.py", "kafka_wire.py"):
        text = (ROOT / "kafka_topic_analyzer_tpu_torch" / "io" / name).read_text()
        assert "kafka_topic_analyzer_tpu.io" not in text and "libkta_ingest.v" not in text


# -- compression codecs ------------------------------------------------------

def payloads():
    rng = np.random.default_rng(9)
    yield b""
    yield b"a"
    yield rng.bytes(5000)
    yield (b"kafka-topic-analyzer " * 3000)
    yield bytes(rng.integers(0, 4, 70000, dtype=np.uint8))


@pytest.mark.parametrize("name", ["snappy", "lz4", "zstd"])
def test_compression_round_trips_across_packages(name):
    enc = {"snappy": "snappy_compress_xerial", "lz4": "lz4_compress_frame",
           "zstd": "zstd_compress_frame"}[name]
    dec = f"{name}_decompress"
    for data in payloads():
        mine, theirs = getattr(comp, enc)(data), getattr(ref_comp, enc)(data)
        if name != "zstd":  # zstd frames come from libzstd or a raw-block writer
            assert mine == theirs
        assert getattr(ref_comp, dec)(mine) == data
        assert getattr(comp, dec)(theirs) == data
        assert getattr(comp, dec)(mine) == data
    # The Python decoders (the native ones' fallback) agree too.
    for data in payloads():
        if name == "snappy":
            assert comp.snappy_decompress_py(ref_comp.snappy_compress_xerial(data)) == data
        elif name == "lz4":
            assert comp.lz4_decompress_py(ref_comp.lz4_compress_frame(data)) == data
        else:
            frame = ref_comp.zstd_compress_frame(data)
            assert zstd_py.decompress(frame, len(data) + 64) == \
                ref_zstd.decompress(frame, len(data) + 64) == data


def test_gzip_and_malformed_payloads_fail_as_the_reference():
    rng = np.random.default_rng(2)
    data = rng.bytes(3000)
    buf = kc.encode_record_batch([(0, 0, b"k", data)], compression=kc.COMPRESSION_GZIP)
    assert buf == ref_kc.encode_record_batch([(0, 0, b"k", data)],
                                             compression=kc.COMPRESSION_GZIP)
    for codec in (1, 2, 3, 4):
        bad = bytes(rng.integers(0, 256, 200, dtype=np.uint8))
        errs = []
        for mod in (comp, ref_comp):
            try:
                mod.decompress(codec, bad)
                errs.append(None)
            except Exception as e:
                errs.append((type(e).__name__, str(e)))
        assert errs[0] == errs[1], codec
    with pytest.raises(comp.UnsupportedCodecError):
        comp.decompress(7, b"x")
