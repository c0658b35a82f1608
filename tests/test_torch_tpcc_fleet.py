"""The port's fleet audit of a Debezium change-data-capture pipeline of a
TPC-C database (``benchmark/configs/debezium-pg-tpcc-w8.json``), on the
host at a tiny scale: one warehouse, a hundredth of its rows, 3,000
transactions, one record a batch (so no event is left in an open batch),
2^22 alive slots.

The benchmark's generator (`benchmark.gen.tpcc_cdc`) writes the nine
table topics and its loopback cluster (`benchmark.gen.cluster`) serves
them; the port's ``--fleet --json`` audit is held to the benchmark's plain
numpy reference topic by topic (exact counters, extremes and alive keys;
bit-identical sketches), and each topic's alive keys to the generator's
own table model: the distinct alive-key slots of its live rows, whose
count follows from the snapshot and the transactions (new_order: the
snapshot's rows plus the committed New-Orders less the deliveries). A
fold that drops every other batch fails both."""

from __future__ import annotations

import contextlib
import io
import json
import pathlib

import numpy as np
import pytest

from benchmark.gen.cluster import ClusterBroker
from benchmark.gen.tpcc_cdc import DISTRICTS, TABLES, TpccCdc, key_bytes
from benchmark.reference.compare import compare
from benchmark.reference.hashes import fnv32_variant
from benchmark.reference.report import reference_report
from kafka_topic_analyzer_tpu_torch import cli
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry

ROOT = pathlib.Path(__file__).resolve().parent.parent
BITS = 22
SEED = 2**31 + 21


def tiny_config() -> dict:
    config = json.loads((ROOT / "benchmark/configs/debezium-pg-tpcc-w8.json").read_text())
    config["topic"].update(warehouses=1, transactions=3000, population_scale=0.01,
                           records_per_batch=1, slot_bits=BITS)
    config["argv"] = config["argv"] + ["--alive-bitmap-bits", str(BITS), "--batch-size",
                                       "4096", "--device", "cpu"]
    config["argv"][config["argv"].index("--ingest-workers") + 1] = "2"
    return config


@pytest.fixture(scope="module")
def cluster():
    config = tiny_config()
    db = TpccCdc(config, SEED)
    broker = ClusterBroker(db.topics, config["topic"]["brokers"]).start()
    yield config, db, broker
    broker.stop()


def fleet_audit(config: dict, broker) -> dict:
    default_registry().reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["-b", f"127.0.0.1:{broker.ports[0]}", "--json", "--quiet",
                       *config["argv"]])
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def audited(cluster):
    config, db, broker = cluster
    return fleet_audit(config, broker)


def gaps(doc: dict, config: dict, db: TpccCdc) -> "dict[str, dict]":
    return {t.name: compare(doc["topics"][t.name],
                            reference_report(t, t.heads, config["argv"]))
            for t in db.topics}


def test_the_generator_writes_the_tpcc_footprints(cluster):
    config, db, _ = cluster
    topics = dict(zip(TABLES, db.topics))
    committed = db.live_rows("orders") - DISTRICTS * db.n_orders
    assert 0 < committed <= db.counts["new_order"]
    assert topics["warehouse"].records == 1 + db.counts["payment"]
    assert topics["district"].records == DISTRICTS + committed + db.counts["payment"]
    assert topics["history"].records == db.live_rows("history")
    assert topics["history"].keys is None
    tomb = int((topics["new_order"].vlen < 0).sum())
    assert tomb == db.deliveries > 0
    assert topics["new_order"].records == DISTRICTS * db.n_new + committed + 2 * db.deliveries
    widths = {n: None if t.keys is None else t.keys.shape[1] for n, t in topics.items()}
    assert widths == config["topic"]["key_bytes"]


def test_fleet_audit_equals_the_reference_topic_by_topic(audited, cluster):
    config, db, _ = cluster
    assert set(audited["topics"]) == {t.name for t in db.topics}
    for name, g in gaps(audited, config, db).items():
        assert g["counters_mismatch"] == 0 and g["extremes_mismatch"] == 0, name
        assert g["alive_keys_gap"] == 0, name
        assert g["hll_rel_gap"] == 0.0 and g["quantile_rel_gap"] == 0.0, name


def test_alive_keys_are_the_table_models_live_rows(audited, cluster):
    config, db, _ = cluster
    committed = db.live_rows("orders") - DISTRICTS * db.n_orders
    assert db.live_rows("warehouse") == db.W
    assert db.live_rows("new_order") == DISTRICTS * db.n_new + committed - db.deliveries
    for name, topic in zip(TABLES, db.topics):
        got = audited["topics"][topic.name]["alive_keys"]
        cols = db.live_columns(name)
        if cols is None:
            assert got == 0
            continue
        # Live rows whose keys share a slot count once, as in the report.
        slots = fnv32_variant(key_bytes(cols, TABLES.index(name) + 1)) & np.uint32((1 << BITS) - 1)
        assert got == len(np.unique(slots)), name
        assert 0.99 * len(cols) <= got <= len(cols), name


def test_a_fold_that_drops_batches_fails_both(cluster, monkeypatch):
    config, db, broker = cluster
    update = TorchBackend.update
    seen = {"n": 0}

    def every_other(self, batch):
        seen["n"] += 1
        if seen["n"] % 2:
            update(self, batch)

    monkeypatch.setattr(TorchBackend, "update", every_other)
    doc = fleet_audit(config, broker)
    worst = {k: max(g[k] for g in gaps(doc, config, db).values())
             for k in ("counters_mismatch", "alive_keys_gap")}
    assert worst["counters_mismatch"] > 0 and worst["alive_keys_gap"] > 0
    live = doc["topics"][db.topics[TABLES.index("new_order")].name]["alive_keys"]
    assert live != db.live_rows("new_order")
