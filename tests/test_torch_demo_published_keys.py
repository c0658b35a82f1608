"""The port's ``-c`` audit of the upstream demo topic at its published key
density (``benchmark/configs/xenji-demo-published-keys.json``: every record
a distinct key), on the host at a tiny scale: 10 partitions of 9,600
records, 150 templates of 64 a partition, so no key recurs.

At ``--alive-bitmap-bits 24`` an exact alive set may hold 2^17 entries: it
starts at 2^16, grows once, and past 2^16 inserted slots (about three
quarters of the way through the topic) switches to the dense bitmap, which
takes the rest of the pairs; at ``--alive-bitmap-bits 22`` the backend
holds the dense bitmap from the start.  Each audit, through the port's CLI
(``--json``) against the benchmark's template broker, is held to the
benchmark's plain numpy reference (exact counters, extremes and alive
keys; bit-identical sketches); its counters to the grows and the switch
it made, to the bytes its grows staged through the host, to the pairs
the dense bitmap's kernel took and to the spans' own durations and
phases in ``--trace-json``.  A switch whose load drops its last
chunk of slots fails on the alive keys."""

from __future__ import annotations

import contextlib
import io
import json
import pathlib

import numpy as np
import pytest

from benchmark.gen.broker import TemplateBroker
from benchmark.gen.topic import Topic
from benchmark.reference.compare import compare
from benchmark.reference.report import reference_report
from kafka_topic_analyzer_tpu_torch import cli
from kafka_topic_analyzer_tpu_torch.backends import alive as alive_mod
from kafka_topic_analyzer_tpu_torch.models import state as state_mod
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEED = 2**31 + 25
RECORDS, TEMPLATES = 9_600, 150

#: case -> (alive bitmap bits, extra CLI arguments, grows, switches)
CASES = {
    "switch mid-audit": (24, [], 1, 1),
    "switch mid-audit, superbatch 3": (24, ["--superbatch", "3"], 1, 1),
    "dense from the start": (22, [], 0, 0),
}


def tiny_config(bits: int) -> dict:
    config = json.loads(
        (ROOT / "benchmark/configs/xenji-demo-published-keys.json").read_text())
    config["topic"].update(records_per_partition=RECORDS,
                           templates_per_partition=TEMPLATES, slot_bits=bits)
    config["argv"] = config["argv"] + ["--alive-bitmap-bits", str(bits),
                                       "--batch-size", "4096", "--device", "cpu"]
    config["argv"][config["argv"].index("--ingest-workers") + 1] = "2"
    return config


class Brokers:
    """A template broker a bitmap size, built at first use and served for
    the module's tests."""

    def __init__(self):
        self._up = {}

    def __call__(self, bits: int):
        if bits not in self._up:
            config = tiny_config(bits)
            topic = Topic(config, SEED, name=f"published-keys-{bits}")
            broker = TemplateBroker(topic, RECORDS // topic.R, topic.brokers).start()
            self._up[bits] = (config, topic, broker)
        return self._up[bits]

    def stop(self) -> None:
        for _, _, broker in self._up.values():
            broker.stop()


@pytest.fixture(scope="module")
def served():
    brokers = Brokers()
    yield brokers
    brokers.stop()


def audit(config: dict, topic: Topic, broker, extra=(), trace=None) -> dict:
    default_registry().reset()
    argv = ["-t", topic.name, "-b", f"127.0.0.1:{broker.ports[0]}", "--json",
            "--quiet", *config["argv"], *extra]
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


def counter(name: str) -> float:
    samples = default_registry().snapshot()[name]["samples"]
    return sum(s["value"] for s in samples)


def spans(path) -> "list[dict]":
    events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


@pytest.mark.parametrize("bits", [24, 22])
def test_every_record_is_a_distinct_key(served, bits):
    _, topic, _ = served(bits)
    assert topic.T * topic.R == RECORDS
    assert len(np.unique(topic.keys, axis=0)) == topic.P * RECORDS


@pytest.mark.parametrize("case", list(CASES))
def test_audit_equals_the_reference_across_grows_and_the_switch(
        served, case, tmp_path, monkeypatch):
    bits, extra, grows, switches = CASES[case]
    config, topic, broker = served(bits)
    applied = []
    apply = state_mod.bitmap_apply_pairs

    def counted(words, slot, flag, n_pairs, **kw):
        applied.append(int(n_pairs))
        return apply(words, slot, flag, n_pairs, **kw)

    monkeypatch.setattr(state_mod, "bitmap_apply_pairs", counted)
    trace = tmp_path / "trace.json"
    doc = audit(config, topic, broker, extra, trace)
    g = gaps(doc, config, topic)
    assert g["counters_mismatch"] == 0 and g["extremes_mismatch"] == 0
    assert g["alive_keys_gap"] == 0
    assert g["hll_rel_gap"] == 0.0 and g["quantile_rel_gap"] == 0.0
    assert doc["alive_keys"] > 0.9 * topic.P * RECORDS * 58 / 64

    assert counter("kta_alive_set_grows_total") == grows
    assert counter("kta_alive_dense_conversions_total") == switches
    # Every pair the dense bitmap's kernel took, the switch's load included.
    assert counter("kta_alive_dense_pairs_total") == sum(applied) > 0
    if not switches:
        assert sum(applied) == counter("kta_alive_pairs_emitted_total")
    else:
        assert sum(applied) < counter("kta_alive_pairs_emitted_total")

    events = spans(trace)
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    grown = by_name.get("alive-grow", [])
    switched = by_name.get("alive-switch", [])
    assert (len(grown), len(switched)) == (grows, switches)
    for e in grown:
        assert (e["args"]["from"], e["args"]["to"]) == (1 << 16, 1 << 17)
    # Each grow stages the 2^16-entry table's keys and bits through the host.
    assert counter("kta_alive_grow_staged_bytes_total") == grows * (4 + 1 / 8) * (1 << 16)
    # Each counter books its spans' own durations.
    for name, spans_of in (("kta_alive_grow_seconds_total", grown),
                           ("kta_alive_switch_seconds_total", switched)):
        assert counter(name) == pytest.approx(sum(e["dur"] for e in spans_of) / 1e6,
                                              rel=1e-9, abs=1e-12)
    for span_of, phases in ((grown, ["stage", "reinsert"]),
                            (switched, ["copy", "slots", "load"])):
        for e in span_of:
            inner = [c for c in events
                     if c.get("args", {}).get("parent") == e["args"]["id"]]
            assert [c["name"] for c in sorted(inner, key=lambda c: c["ts"])] == phases


def test_a_switch_that_drops_its_last_chunk_fails_on_the_alive_keys(served, monkeypatch):
    config, topic, broker = served(24)
    monkeypatch.setattr(alive_mod, "LOAD_CHUNK", 1 << 12)
    load = alive_mod.AliveTable._load

    def drop_last(self, alive, slots):
        keep = (slots.size - 1) // alive_mod.LOAD_CHUNK * alive_mod.LOAD_CHUNK
        load(self, alive, slots[:keep])

    monkeypatch.setattr(alive_mod.AliveTable, "_load", drop_last)
    doc = audit(config, topic, broker)
    assert counter("kta_alive_dense_conversions_total") == 1
    g = gaps(doc, config, topic)
    assert g["counters_mismatch"] == 0 and g["extremes_mismatch"] == 0
    assert 0 < g["alive_keys_gap"] <= alive_mod.LOAD_CHUNK
