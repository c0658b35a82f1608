"""The port's ``-c`` audit of the upstream demo topic produced with LZ4
(``benchmark/configs/xenji-demo-lz4.json``), on the host at a tiny scale: 4
partitions of 4,000 records, every key twice, both sketches, against the
benchmark's compressed template broker (every batch one LZ4 frame).

The fused decode->pack walk stops at a compressed frame, so every record
takes the per-frame chain: the frame's LZ4 decode, the native record
decode, and ``FusedPackSink.append_batch`` into the rows. Each audit,
through the port's CLI (``--json``), is held to the benchmark's plain numpy
reference (exact counters, extremes and alive keys; bit-identical
sketches); its counters to the records that took the chain; and the spans
``decompress`` and ``frame-fallback`` in ``--trace-json`` to the counters
that book their durations and bytes. The cases: batches of one compressed
64 KiB block, of one block stored raw (random values), of several blocks
(1,000 records, ~200 KB), and rows that end inside a frame. An
``append_batch`` that drops each frame's last record fails on the
counters."""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import struct

import pytest

from benchmark.gen.compressed import CompressedTemplateBroker
from benchmark.gen.encode import encode_templates
from benchmark.gen.topic import Topic
from benchmark.reference.compare import compare
from benchmark.reference.report import reference_report
from kafka_topic_analyzer_tpu_torch import cli, packing
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEED = 2**31 + 27
PARTITIONS, RECORDS = 4, 4_000

#: case -> (records a batch, values, --batch-size)
CASES = {
    "compressed blocks": (200, "json", 4000),
    "stored blocks": (200, "random", 4000),
    "across the 64 KiB block boundary": (1000, "json", 4000),
    "row boundary inside a frame": (1000, "json", 4096),
}


def tiny_config(per_batch: int, values: str, batch_size: int) -> dict:
    config = json.loads((ROOT / "benchmark/configs/xenji-demo-lz4.json").read_text())
    # Half the records' keys: each key is written twice, as in the demo.
    config["topic"].update(partitions=PARTITIONS, records_per_partition=RECORDS,
                           records_per_batch=per_batch,
                           templates_per_partition=RECORDS // 2 // per_batch,
                           values=values, slot_bits=24)
    config["argv"] = config["argv"] + ["--alive-bitmap-bits", "24", "--batch-size",
                                       str(batch_size), "--device", "cpu"]
    config["argv"][config["argv"].index("--ingest-workers") + 1] = "2"
    return config


class Brokers:
    """A compressed template broker a case, built at first use and served
    for the module's tests."""

    def __init__(self):
        self._up = {}

    def __call__(self, case: str):
        if case not in self._up:
            config = tiny_config(*CASES[case])
            topic = Topic(config, SEED, name=f"demo-lz4-{len(self._up)}")
            t = config["topic"]
            broker = CompressedTemplateBroker(topic, RECORDS // topic.R, topic.brokers,
                                              codec=t["compression"], values=t["values"]).start()
            self._up[case] = (config, topic, broker)
        return self._up[case]

    def stop(self) -> None:
        for _, _, broker in self._up.values():
            broker.stop()


@pytest.fixture(scope="module")
def served():
    brokers = Brokers()
    yield brokers
    brokers.stop()


def audit(config: dict, topic: Topic, broker, trace=None) -> dict:
    default_registry().reset()
    argv = ["-t", topic.name, "-b", f"127.0.0.1:{broker.ports[0]}", "--json", "--quiet",
            *config["argv"]]
    if trace is not None:
        argv += ["--trace-json", str(trace)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def gaps(doc: dict, config: dict, topic: Topic) -> dict:
    ref = reference_report(topic, [RECORDS // topic.R] * topic.P, config["argv"])
    return compare(doc, ref)


def counter(name: str, **labels) -> float:
    samples = default_registry().snapshot()[name]["samples"]
    return sum(s["value"] for s in samples
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def blocks(batch: bytes) -> "list[tuple[bool, int]]":
    """(stored raw, bytes) of each block of a batch's LZ4 frame."""
    out, at = [], 61 + 7
    while True:
        (size,) = struct.unpack_from("<I", batch, at)
        if size == 0:
            return out
        out.append((bool(size >> 31), size & 0x7FFFFFFF))
        at += 4 + (size & 0x7FFFFFFF)


@pytest.mark.parametrize("case", list(CASES))
def test_every_batch_is_an_lz4_frame_of_the_case(served, case):
    _, topic, broker = served(case)
    per_batch, values, _ = CASES[case]
    shapes = []
    for tail in broker.tmpl_tail:
        batch = bytes(8) + bytes(tail)
        (attributes,) = struct.unpack_from(">h", batch, 21)
        assert attributes & 0x07 == 3
        assert struct.unpack_from("<I", batch, 61)[0] == 0x184D2204
        shapes.append(blocks(batch))
    stored = {raw for shape in shapes for raw, _ in shape}
    assert stored == ({True} if values == "random" else {False})
    many = {len(shape) > 1 for shape in shapes}
    assert many == ({True} if per_batch == 1000 else {False})


@pytest.mark.parametrize("case", list(CASES))
def test_audit_takes_the_compressed_path_and_equals_the_reference(
        served, case, tmp_path, monkeypatch):
    config, topic, broker = served(case)
    per_batch, _, batch_size = CASES[case]
    rows = []
    complete = packing.FusedPackSink._complete_row

    def counted(self):
        rows.append(self._count)
        complete(self)

    monkeypatch.setattr(packing.FusedPackSink, "_complete_row", counted)
    trace = tmp_path / "trace.json"
    doc = audit(config, topic, broker, trace)
    g = gaps(doc, config, topic)
    assert g["counters_mismatch"] == 0 and g["extremes_mismatch"] == 0
    assert g["alive_keys_gap"] == 0
    assert g["hll_rel_gap"] == 0.0 and g["quantile_rel_gap"] == 0.0

    records = PARTITIONS * RECORDS
    # Every record entered the rows through the per-frame chain: the rows
    # hold them all, the fused walk none.
    assert counter("kta_fused_fallback_total", reason="frame-fallback") == records
    assert counter("kta_fused_fallback_total") == records
    assert counter("kta_fused_records_total") == sum(rows) == records
    if case == "row boundary inside a frame":
        assert any(n % per_batch for n in rows[:-1])
    else:
        assert all(n % per_batch == 0 for n in rows)
    assert max(rows) <= batch_size

    events = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") == "X"]
    unpacked = [e for e in events if e["name"] == "decompress"]
    chains = [e for e in events if e["name"] == "frame-fallback"]
    frames = PARTITIONS * RECORDS // per_batch
    assert len(unpacked) == sum(e["args"]["frames"] for e in chains) == frames
    assert sum(e["args"]["records"] for e in chains) == records
    chain_ids = {e["args"]["id"] for e in chains}
    assert {e["args"]["parent"] for e in unpacked} <= chain_ids
    assert {e["args"]["codec"] for e in unpacked} == {"lz4"}
    for name, spans_of in (("kta_decompress_seconds_total", unpacked),
                           ("kta_frame_fallback_seconds_total", chains)):
        assert counter(name) == pytest.approx(sum(e["dur"] for e in spans_of) / 1e6,
                                              rel=1e-9, abs=1e-12)
    assert counter("kta_decompress_in_bytes_total", codec="lz4") == sum(
        e["args"]["in"] for e in unpacked)
    out = counter("kta_decompress_out_bytes_total", codec="lz4")
    assert out == sum(e["args"]["out"] for e in unpacked)
    # Each window's records section decompresses to what its uncompressed
    # template carries after the 61-byte header.
    _, _, lens = encode_templates(topic)
    uses = topic.template_uses([topic.windows] * topic.P).reshape(-1)
    assert out == int(((lens - 61) * uses).sum())


def test_an_append_batch_that_drops_a_frames_last_record_fails(served, monkeypatch):
    config, topic, broker = served("across the 64 KiB block boundary")
    append = packing.FusedPackSink.append_batch

    def drop_last(self, batch, reason):
        return append(self, batch.slice(0, len(batch) - 1), reason)

    monkeypatch.setattr(packing.FusedPackSink, "append_batch", drop_last)
    doc = audit(config, topic, broker)
    assert gaps(doc, config, topic)["counters_mismatch"] > 0
