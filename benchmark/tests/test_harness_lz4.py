"""The LZ4 cell (``demo-lz4.audit``) and the keyless follow cell
(``omb-16p-1kb.follow``): the compressed templates the C encoder writes,
checked by a plain-Python LZ4 frame decoder, xxHash32 and CRC32-C kept
here; the cells' entries in ``BENCHMARK.json``; their eight readers on a
small recorded fixture and on runs in which they find nothing; and whole
runs of both cells on the host at a tiny size."""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import pytest

from benchmark import run
from benchmark.gen.compressed import compress_templates, xxh32
from benchmark.gen.encode import encode_templates
from benchmark.gen.topic import Topic
from benchmark.run import load_reader
from benchmark.tests.conftest import tiny_manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LZ4_CELL, FOLLOW_CELL = "demo-lz4.audit", "omb-16p-1kb.follow"
LZ4_READERS = ["decompress_share.lz4", "decompress_gb_per_s.lz4", "frame_fallback_share.lz4",
               "fused_record_share.lz4", "audit_records_per_s.lz4", "device_idle_share.lz4"]
FOLLOW_READERS = ["delivery_ms_p95.keyless", "device_idle_share.keyless"]


# -- plain-Python twins of the codec's checks ----------------------------------------


def xxh32_py(data: bytes, seed: int = 0) -> int:
    P1, P2, P3, P4, P5 = 2654435761, 2246822519, 3266489917, 668265263, 374761393
    M = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & M

    n, p = len(data), 0
    if n >= 16:
        v = [(seed + P1 + P2) & M, (seed + P2) & M, seed, (seed - P1) & M]
        while p + 16 <= n:
            for j in range(4):
                (w,) = struct.unpack_from("<I", data, p + 4 * j)
                v[j] = rotl((v[j] + w * P2) & M, 13) * P1 & M
            p += 16
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while p + 4 <= n:
        (w,) = struct.unpack_from("<I", data, p)
        h = rotl((h + w * P3) & M, 17) * P4 & M
        p += 4
    while p < n:
        h = rotl((h + data[p] * P5) & M, 11) * P1 & M
        p += 1
    h ^= h >> 15
    h = h * P2 & M
    h ^= h >> 13
    h = h * P3 & M
    return h ^ (h >> 16)


def _crc32c_table() -> "list[int]":
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


CRC_TABLE = _crc32c_table()


def crc32c_py(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def lz4_block_py(block: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(block):
        token = block[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = block[i]
                i += 1
                lit += b
                if b != 255:
                    break
        out += block[i:i + lit]
        i += lit
        if i == len(block):
            break
        off = block[i] | block[i + 1] << 8
        i += 2
        assert 0 < off <= len(out)
        m = token & 15
        if m == 15:
            while True:
                b = block[i]
                i += 1
                m += b
                if b != 255:
                    break
        for _ in range(m + 4):
            out.append(out[-off])
    return bytes(out)


def lz4_frame_py(frame: bytes) -> "tuple[bytes, list[bool]]":
    """The frame's content, and for each block whether it was stored raw;
    asserts the header Kafka's LZ4 output stream writes."""
    assert struct.unpack_from("<I", frame, 0)[0] == 0x184D2204
    assert frame[4:6] == b"\x60\x40"
    assert frame[6] == (xxh32_py(frame[4:6]) >> 8) & 0xFF
    out, stored, at = bytearray(), [], 7
    while True:
        (size,) = struct.unpack_from("<I", frame, at)
        at += 4
        if size == 0:
            assert at == len(frame)
            return bytes(out), stored
        n = size & 0x7FFFFFFF
        assert n <= 65536
        block = frame[at:at + n]
        stored.append(bool(size >> 31))
        content = block if size >> 31 else lz4_block_py(block)
        assert len(content) <= 65536
        out += content
        at += n


def tiny_topic(per_batch: int = 300) -> Topic:
    config = json.loads((ROOT / "benchmark/configs/xenji-demo-lz4.json").read_text())
    config["topic"].update(partitions=2, records_per_partition=4 * per_batch,
                           records_per_batch=per_batch, templates_per_partition=2, slot_bits=24)
    return Topic(config, 2**31 + 91)


@pytest.mark.parametrize("values", ["json", "random"])
def test_every_template_decodes_to_its_records_section(values):
    topic = tiny_topic()
    raw, starts, lens = encode_templates(topic)
    zero = raw.copy()
    buf, cstarts, clens = compress_templates(raw, lens, topic.seed, values)
    assert len(cstarts) == len(starts) == topic.P * topic.T
    for k in range(len(starts)):
        was = bytes(raw[starts[k]:starts[k] + lens[k]])
        before = bytes(zero[starts[k]:starts[k] + lens[k]])
        got = bytes(buf[cstarts[k]:cstarts[k] + clens[k]])
        content, stored = lz4_frame_py(got[61:])
        assert content == was[61:]
        # Only the values changed: every other byte is the template's.
        diff = np.frombuffer(was, np.uint8) != np.frombuffer(before, np.uint8)
        assert np.all(np.frombuffer(before, np.uint8)[diff] == 0)
        assert len(stored) == -(-(len(was) - 61) // 65536) > 1
        assert set(stored) == ({True} if values == "random" else {False})
        if values == "json":
            assert all(0x20 <= b < 0x7F for b in np.frombuffer(was, np.uint8)[diff])
        # The header is the template's but for the batch length, the codec
        # bits and the CRC32-C, which covers attributes onward.
        assert got[:8] == was[:8] and got[12:17] == was[12:17] and got[23:61] == was[23:61]
        assert struct.unpack_from(">i", got, 8)[0] == len(got) - 12
        assert struct.unpack_from(">h", got, 21)[0] == 3
        assert struct.unpack_from(">I", got, 17)[0] == crc32c_py(got[21:])


def test_json_values_compress_and_the_checksum_is_xxh32():
    topic = tiny_topic()
    raw, _, lens = encode_templates(topic)
    _, _, clens = compress_templates(raw, lens, topic.seed, "json")
    assert 1.5 < lens.sum() / clens.sum() < 4.0
    # Kafka's LZ4 frames open 04 22 4D 18 60 40 82.
    assert (xxh32(b"\x60\x40") >> 8) & 0xFF == 0x82
    for data in (b"", b"\x60\x40", bytes(range(37)), b"abc" * 100):
        assert xxh32(data) == xxh32_py(data)
        assert xxh32(data, 7) == xxh32_py(data, 7)


def test_the_same_seed_gives_the_same_batches():
    topic = tiny_topic()
    out = []
    for _ in range(2):
        raw, _, lens = encode_templates(topic)
        out.append(compress_templates(raw, lens, topic.seed, "json")[0])
    assert np.array_equal(out[0], out[1])


# -- the manifest ----------------------------------------------------------------------


def test_the_manifest_has_the_configuration_and_both_cells():
    conf = next(c for c in BENCH["configs"] if c["name"] == "xenji-demo-lz4")
    demo = json.loads((ROOT / "benchmark/configs/xenji-demo-compacted.json").read_text())
    config = json.loads((ROOT / conf["file"]).read_text())
    assert conf["reduced"] == list(config["reduced"]) == list(demo["reduced"])
    assert config["argv"] == demo["argv"]
    assert {k: v for k, v in config["published"].items() if k != "producer"} == demo["published"]
    assert config["published"]["producer"]["compression.type"] == "lz4"
    t = config["topic"]
    assert (t["records_per_batch"], t["templates_per_partition"], t["compression"]) == (
        1000, 800, "lz4")
    changed = {"records_per_batch", "templates_per_partition", "compression", "values"}
    assert {k: v for k, v in t.items() if k not in changed} == {
        k: v for k, v in demo["topic"].items() if k not in changed}
    # The demo's 800,000 distinct keys a partition.
    assert t["records_per_batch"] * t["templates_per_partition"] == t["distinct_keys_per_partition"]
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert (cells[LZ4_CELL]["config"], cells[LZ4_CELL]["traffic"], cells[LZ4_CELL]["chips"]) == (
        "xenji-demo-lz4", "audit_compressed", 1)
    assert (cells[FOLLOW_CELL]["config"], cells[FOLLOW_CELL]["traffic"],
            cells[FOLLOW_CELL]["chips"]) == ("omb-1topic-16p-1kb", "follow", 1)
    lz4 = json.loads((ROOT / f"benchmark/workloads/{LZ4_CELL}.json").read_text())
    demo_params = json.loads((ROOT / "benchmark/workloads/demo-compacted.audit.json").read_text())
    assert lz4 == demo_params
    follow = json.loads((ROOT / f"benchmark/workloads/{FOLLOW_CELL}.json").read_text())
    assert set(follow) == {"rate", "settle_s", "limits"} and follow["rate"] > 0
    assert follow["limits"] == {"counters_mismatch": 0, "extremes_mismatch": 0}
    for cell, readers in ((LZ4_CELL, LZ4_READERS), (FOLLOW_CELL, FOLLOW_READERS)):
        reading = [m for m in BENCH["per_layer"] if cell in m["workloads"]]
        assert sorted(m["name"] for m in reading) == sorted(readers)
        for m in reading:
            assert m["workloads"] == [cell] and m["moves"] == "device_memory_peak_bytes"


# -- the readers -----------------------------------------------------------------------

CONFIG = {"topic": {"partitions": 10}, "argv": ["-c"]}
COUNTERS = {
    "kta_ingest_worker_active_seconds_total{worker=w0}": 10.0,
    "kta_ingest_worker_active_seconds_total{worker=w1}": 10.0,
    "kta_decompress_seconds_total{codec=lz4}": 2.0,
    "kta_decompress_in_bytes_total{codec=lz4}": 1.0e9,
    "kta_decompress_out_bytes_total{codec=lz4}": 3.0e9,
    "kta_frame_fallback_seconds_total": 8.0,
    "kta_fused_records_total": 32e6,
    "kta_fused_fallback_total{reason=frame-fallback}": 32e6,
}
DEVICE = {"busy_s": 0.25, "window_s": 10.0, "stage_device_s": {"dispatch": 0.25},
          "ops": {"Memcpy HtoD (Pinned -> Device)": (0.25, 80)}, "idle_gaps": {"ingest": 9.75}}
LAYER = {"counters": COUNTERS, "walls": [5.0, 5.0], "records": 32_000_000, "window_s": 10.0,
         "device": DEVICE,
         "frames": [(100.0 + i, {"report_ts": 100.0 + i - 0.002 * (i + 1)}) for i in range(20)]}
EXPECTED = {
    "decompress_share.lz4": 0.1,
    "decompress_gb_per_s.lz4": 1.5,
    "frame_fallback_share.lz4": 0.4,
    "fused_record_share.lz4": 0.0,
    "audit_records_per_s.lz4": 3_200_000.0,
    "device_idle_share.lz4": 0.975,
    "delivery_ms_p95.keyless": 38.0,
    "device_idle_share.keyless": 0.975,
}
EMPTY = {"counters": {}, "walls": [], "device": None, "frames": []}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_fixture(name):
    assert load_reader(name)(LAYER, CONFIG) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing(name):
    assert load_reader(name)(EMPTY, CONFIG) is None


@pytest.mark.parametrize("name", ["decompress_share.lz4", "decompress_gb_per_s.lz4",
                                  "frame_fallback_share.lz4"])
def test_reader_finds_nothing_without_the_new_counters(name):
    """A program that books neither the decompression's nor the per-frame
    chain's seconds (the cell's parent) leaves those metrics out."""
    counters = {k: v for k, v in COUNTERS.items()
                if not k.startswith(("kta_decompress", "kta_frame_fallback"))}
    assert load_reader(name)(dict(LAYER, counters=counters), CONFIG) is None


def test_the_fused_share_counts_the_walks_own_records():
    """Rows filled by the fused walk alone read 1; half through the chain, 0.5."""
    counters = {"kta_fused_records_total": 100.0}
    read = load_reader("fused_record_share.lz4")
    assert read(dict(LAYER, counters=counters), CONFIG) == 1.0
    counters["kta_fused_fallback_total{reason=python-decode}"] = 50.0
    assert read(dict(LAYER, counters=counters), CONFIG) == 0.5


# -- whole runs on the host ------------------------------------------------------------


@pytest.fixture(scope="module")
def manifest(tmp_path_factory) -> Path:
    """The tiny manifest, the keyless follow cell's rate cut to what the
    host folds (the cell's own rate is the card's)."""
    path = tiny_manifest(tmp_path_factory.mktemp("bench-lz4"))
    params = path.parent / "benchmark" / "workloads" / f"{FOLLOW_CELL}.json"
    params.write_text(json.dumps(dict(json.loads(params.read_text()), rate=20000)))
    return path


def one_run(manifest, cell, capfd, trace):
    rc = run.main(["--workload", cell, "--seed", str(2**31 + 79), "--seconds", "2",
                   "--trace", str(trace)], manifest=manifest, cpu=True)
    out = capfd.readouterr()
    assert rc == 0, out.err[-2000:]
    result = json.loads(out.out.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    return result, out.err


def test_the_lz4_cell_runs_correct_on_the_host(manifest, capfd):
    result, err = one_run(manifest, LZ4_CELL, capfd, 1)
    assert "lz4 templates:" in err
    m = {k: v["value"] for k, v in result["metrics"].items()}
    # The host has no device timeline: the trace's reader finds nothing.
    assert set(m) == set(LZ4_READERS) - {"device_idle_share.lz4"}
    assert m["fused_record_share.lz4"] == 0.0
    assert 0 < m["decompress_share.lz4"] < m["frame_fallback_share.lz4"] < 1


def test_the_lz4_cell_reports_the_end_to_end_metrics(manifest, capfd):
    result, _ = one_run(manifest, LZ4_CELL, capfd, 0)
    assert set(result["metrics"]) == {"setup_s", "device_memory_peak_bytes"}


def test_the_keyless_follow_cell_runs_correct_on_the_host(manifest, capfd):
    result, _ = one_run(manifest, FOLLOW_CELL, capfd, 1)
    assert "delivery_ms_p95.keyless" in result["metrics"]
    assert "alive_keys_gap" not in result["checks"]
