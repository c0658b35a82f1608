"""The Debezium change-data-capture topics of a TPC-C database, drawn from a
configuration and a seed: one topic a table.

Sources: the TPC-C Standard Specification 5.11 (clause 1: the nine tables,
their primary keys and typical row sizes; 4.3: the initial population; 5.2.3:
the mix; 2: what each transaction writes) and Debezium's PostgreSQL
connector (a topic a table, ``<prefix>.<schema>.<table>``; the message key
is the row's primary key, null for a table without one; ``snapshot.mode=
initial``; ``REPLICA IDENTITY DEFAULT``; ``tombstones.on.delete=true``).

A plain in-memory model of the nine tables (the configuration's
``published`` schema) is loaded and read once by the snapshot: one read
event a row, in primary-key order. The mix then runs ``transactions``
transactions from the seed, and every committed write is one event of its
table's topic, in commit order:

- New-Order (45%): inserts the order and its new_order row and ``ol_cnt``
  (uniform 5-15) order_lines, updates the ``ol_cnt`` stock rows of its
  items (NURand(8191, 1, 100000); 1% of lines from a remote warehouse) and
  its district. 1% roll back and write nothing.
- Payment (43%): updates the warehouse, the district and the customer (15%
  of a remote warehouse; 60% chosen by last name NURand(255, 0, 999), the
  middle one by first name, else NURand(1023, 1, 3000)) and inserts a
  history row.
- Delivery (4%): in each of the warehouse's 10 districts with an
  undelivered order, deletes the oldest new_order row (a delete event,
  then its tombstone), updates the order, its order_lines and its
  customer.
- Order-Status and Stock-Level (4% each) write nothing.

An insert, read or update event's value is the row's typical size plus
``envelope_bytes`` (``REPLICA IDENTITY DEFAULT``: the after image only); a
delete's is 4 bytes a key column plus the envelope; a tombstone's is null.
A key is the Confluent framing (a zero byte and the key schema's 4-byte id,
the table's place in the schema plus one) and 4 bytes, big-endian, a key
column: keys of one width a table.

The topic's layout (``topic``): ``partitions`` a table (a keyed event goes
to partition ``slot % P`` of its alive-key slot, the low ``slot_bits`` bits
of its ``fnv32_variant``, so no two partitions share a slot; a null-keyed
one round robin), ``records_per_batch`` (one number, or one a table),
``brokers`` nodes (partition p of table k led by node (k + p) % brokers).
Each partition holds its events up to its last whole batch: the open
batch, fewer than ``R`` events, is left out. ``population_scale`` (default
1) loads that share of the published per-warehouse rows and items.
``records_per_partition``, where given, scales the rows and the
transactions together by one factor so that a partition holds that many
records on average: the harness's CPU tests cut every configuration so
(``templates_per_partition``, which the cut sets too, is not read: every
batch of a change stream is its own). Timestamps are the generator's: one millisecond a record of a partition
from `benchmark.gen.topic.BASE_TS_MS`.
"""

from __future__ import annotations

import numpy as np

from benchmark.gen.topic import BASE_TS_MS, Topic
from benchmark.reference.hashes import fnv32_variant

TABLES = ("warehouse", "district", "customer", "history", "orders", "new_order",
          "order_line", "stock", "item")
KINDS = ("new_order", "payment", "order_status", "delivery", "stock_level")
DISTRICTS = 10
#: The most order_lines an order has (``ol_cnt`` is at most 15).
MAX_LINES = 15
KEY_FRAMING_BYTES = 5
KEY_COLUMN_BYTES = 4


def _nurand(rng: np.random.Generator, a: int, x: int, y: int, c: int, n: int) -> np.ndarray:
    """TPC-C's NURand(A, x, y) with run-time constant ``c`` (clause 2.1.6)."""
    return ((rng.integers(0, a + 1, n) | rng.integers(x, y + 1, n)) + c) % (y - x + 1) + x


def _deck(n: int, shares: "list[float]") -> np.ndarray:
    """How many of ``n`` take each share: rounded down, the rest to the
    largest remainders."""
    raw = np.asarray(shares, dtype=np.float64) * n
    counts = np.floor(raw).astype(np.int64)
    rest = n - int(counts.sum())
    counts[np.argsort(-(raw - counts), kind="stable")[:rest]] += 1
    return counts


class _Log:
    """One table's events, gathered in any order and laid out in commit
    order: by transaction (-1 for the snapshot), then the place ``sub`` of
    the write within it."""

    def __init__(self, key_columns: int):
        self.k = key_columns
        self.parts: list = []

    def add(self, txn, sub, cols, vlen) -> None:
        n = len(vlen)
        self.parts.append((np.broadcast_to(np.asarray(txn, dtype=np.int64), (n,)),
                           np.broadcast_to(np.asarray(sub, dtype=np.int64), (n,)),
                           None if cols is None else np.asarray(cols, dtype=np.int64).reshape(n, self.k),
                           np.broadcast_to(np.asarray(vlen, dtype=np.int32), (n,))))

    def build(self) -> "tuple[np.ndarray | None, np.ndarray]":
        txn = np.concatenate([p[0] for p in self.parts])
        sub = np.concatenate([p[1] for p in self.parts])
        vlen = np.concatenate([p[3] for p in self.parts])
        order = np.argsort(((txn + 1) << 40) | sub, kind="stable")
        cols = None
        if self.k:
            cols = np.concatenate([p[2] for p in self.parts])[order]
        return cols, vlen[order]


class CdcTopic(Topic):
    """One table's topic in `Topic`'s layout: ``T`` windows, each template
    used once, partition ``p`` holding ``heads[p]`` windows."""

    def __init__(self, name: str, keys: "np.ndarray | None", vlen: np.ndarray, *,
                 partitions: int, records_per_batch: int, slot_bits: int, seed: int):
        self.name = name
        self.P = int(partitions)
        self.R = int(records_per_batch)
        self.slot_bits = int(slot_bits)
        self.seed = int(seed)
        self.key_bytes = None if keys is None else keys.shape[1]
        n = len(vlen)
        if keys is None:
            part = np.arange(n, dtype=np.int64) % self.P
        elif self.P == 1:
            part = np.zeros(n, dtype=np.int64)
        else:
            slot = fnv32_variant(keys) & np.uint32((1 << self.slot_bits) - 1)
            part = (slot % np.uint32(self.P)).astype(np.int64)
        picks = [np.flatnonzero(part == p) for p in range(self.P)]
        #: Windows each partition holds.
        self.heads = np.array([len(ix) // self.R for ix in picks], dtype=np.int64)
        self.T = self.windows = int(self.heads.max())
        if self.T == 0:
            raise ValueError(f"topic {name!r} has no whole batch of {self.R} records")
        shape = (self.P, self.T, self.R)
        #: Unused windows (beyond a partition's head) hold zero-byte values
        #: and copies of the partition's first key; nothing reads them.
        self.vlen = np.zeros(shape, dtype=np.int32)
        self.keys = None
        if keys is not None:
            self.keys = np.zeros((self.P, self.T * self.R, keys.shape[1]), dtype=np.uint8)
        for p, ix in enumerate(picks):
            kept = ix[: self.heads[p] * self.R]
            self.vlen[p].reshape(-1)[: len(kept)] = vlen[kept]
            if keys is not None:
                self.keys[p, : len(kept)] = keys[kept]
                if len(kept) < self.T * self.R:
                    self.keys[p, len(kept):] = keys[ix[0]] if len(ix) else 0
        if keys is not None:
            self.keys = self.keys.reshape(self.P * self.T * self.R, -1)
        self.ts_ms = (BASE_TS_MS + np.arange(self.T * self.R, dtype=np.int64)
                      ).reshape(self.T, self.R)

    @property
    def records(self) -> int:
        return int(self.heads.sum()) * self.R


class TpccCdc:
    """The nine topics of one configuration under one seed (``topics``, in
    the schema's table order), and the table model's live rows."""

    def __init__(self, config: dict, seed: int):
        pub, t = config["published"], config["topic"]
        self.seed = int(seed)
        self.schema = pub["tables"]
        self.W = W = int(t["warehouses"])
        scale = float(t.get("population_scale", 1.0))
        self.transactions = int(t["transactions"])
        if "records_per_partition" in t:
            want = float(t["records_per_partition"]) * int(t["partitions"]) * len(TABLES)
            cut = want / expected_records(pub, W, self.transactions, scale)
            scale *= cut
            self.transactions = max(1, int(round(self.transactions * cut)))
        self.n_items = max(1, int(round(self.schema["item"]["rows"] * scale)))
        self.n_cust = max(1, int(round(pub["customers_per_district"] * scale)))
        self.n_orders = max(1, int(round(pub["orders_per_district"] * scale)))
        self.n_new = int(round(self.n_orders * pub["new_orders_per_district"]
                               / pub["orders_per_district"]))
        self.envelope = int(t["envelope_bytes"])
        rng = np.random.default_rng(self.seed)
        self._logs = {name: _Log(len(self.schema[name]["key"] or ())) for name in TABLES}
        self._load(rng, pub)
        self._run(rng, pub)
        rpb = t["records_per_batch"]
        self.topics: "list[CdcTopic]" = []
        for i, name in enumerate(TABLES):
            cols, vlen = self._logs.pop(name).build()
            keys = None if cols is None else key_bytes(cols, i + 1)
            self.topics.append(CdcTopic(
                f"{t['topic_prefix']}.{t['schema']}.{name}", keys, vlen,
                partitions=t["partitions"],
                records_per_batch=rpb if isinstance(rpb, int) else rpb[name],
                slot_bits=t.get("slot_bits", 32), seed=self.seed))

    # -- the events ------------------------------------------------------------

    def _value(self, table: str) -> int:
        return int(self.schema[table]["row_bytes"]) + self.envelope

    def _delete_value(self, table: str) -> int:
        return KEY_COLUMN_BYTES * len(self.schema[table]["key"]) + self.envelope

    def _emit(self, table: str, txn, sub, cols, vlen=None) -> None:
        n = max(np.size(txn), np.size(sub), 0 if cols is None else len(cols))
        self._logs[table].add(txn, sub, cols, np.full(n, self._value(table)) if vlen is None else vlen)

    def _load(self, rng: np.random.Generator, pub: dict) -> None:
        """The initial population (clause 4.3), read by the snapshot."""
        W, nd, nc, no, nn, ni = (self.W, self.W * DISTRICTS, self.n_cust, self.n_orders,
                                 self.n_new, self.n_items)
        w_of = np.repeat(np.arange(1, W + 1), DISTRICTS)
        d_of = np.tile(np.arange(1, DISTRICTS + 1), W)
        self._emit("item", -1, np.arange(ni), np.arange(1, ni + 1))
        self._emit("warehouse", -1, np.arange(W), np.arange(1, W + 1))
        self._emit("stock", -1, np.arange(W * ni),
                   np.stack([np.repeat(np.arange(1, W + 1), ni), np.tile(np.arange(1, ni + 1), W)], 1))
        self._emit("district", -1, np.arange(nd), np.stack([w_of, d_of], 1))
        cust = np.stack([np.repeat(w_of, nc), np.repeat(d_of, nc), np.tile(np.arange(1, nc + 1), nd)], 1)
        self._emit("customer", -1, np.arange(nd * nc), cust)
        self._emit("history", -1, np.arange(nd * nc), None)
        # Last names (clause 4.3.3.1): the first 1,000 customers of a
        # district take names 0..999 in turn, the rest NURand(255, 0, 999)
        # under the load's constant; first names order them at random.
        self.c_load = int(rng.integers(0, 256 - 119))
        c = np.arange(1, nc + 1)
        last = np.where(c <= 1000, c - 1, 0)
        last = np.tile(last, nd)
        late = np.tile(c > 1000, nd)
        last[late] = _nurand(rng, 255, 0, 999, self.c_load, int(late.sum()))
        first = rng.random(nd * nc)
        k = np.repeat(np.arange(nd), nc)
        self._by_name = np.lexsort((first, k * 1000 + last))
        self._name_key = (k * 1000 + last)[self._by_name]
        # Orders: one a customer, in a random order of the customers, 5-15
        # lines each; the last ``nn`` of a district undelivered.
        o_cust = np.argsort(rng.random((nd, nc)), axis=1)[:, :no] + 1
        o_cnt = rng.integers(5, MAX_LINES + 1, (nd, no))
        o = np.arange(1, no + 1)
        self._emit("orders", -1, np.arange(nd * no),
                   np.stack([np.repeat(w_of, no), np.repeat(d_of, no), np.tile(o, nd)], 1))
        newo = o[no - nn:]
        self._emit("new_order", -1, np.arange(nd * nn),
                   np.stack([np.repeat(w_of, nn), np.repeat(d_of, nn), np.tile(newo, nd)], 1))
        lines = o_cnt.reshape(-1)
        n_lines = int(lines.sum())
        first_line = np.cumsum(lines) - lines
        ol_n = np.arange(n_lines) - np.repeat(first_line, lines) + 1
        self._emit("order_line", -1, np.arange(n_lines),
                   np.stack([np.repeat(np.repeat(w_of, no), lines), np.repeat(np.repeat(d_of, no), lines),
                             np.repeat(np.tile(o, nd), lines), ol_n], 1))
        self._o_cust, self._o_cnt = o_cust, o_cnt

    def _run(self, rng: np.random.Generator, pub: dict) -> None:
        """The mix (clause 5.2.3), its writes (clause 2) in commit order."""
        W, nd, nc, no, nn, ni = (self.W, self.W * DISTRICTS, self.n_cust, self.n_orders,
                                 self.n_new, self.n_items)
        T = self.transactions
        counts = _deck(T, [pub["mix"][k] for k in KINDS])
        kind = rng.permutation(np.repeat(np.arange(len(KINDS)), counts))
        self.counts = dict(zip(KINDS, (int(x) for x in counts)))
        w = rng.integers(1, W + 1, T)
        d = rng.integers(1, DISTRICTS + 1, T)
        c_id = int(rng.integers(0, 1024))
        c_item = int(rng.integers(0, 8192))
        deltas = [x for x in range(65, 120) if x not in (96, 112)]
        c_run = self.c_load + int(rng.choice(deltas))
        n_item, n_cid, n_last = (pub["nurand"][k] for k in ("item", "customer_id", "customer_last"))

        def other(home: np.ndarray) -> np.ndarray:
            """A warehouse other than ``home``, uniformly (``home`` if W is 1)."""
            if W == 1:
                return home.copy()
            return (home - 1 + rng.integers(1, W, len(home))) % W + 1

        def pick_customer(n: int) -> np.ndarray:
            return (_nurand(rng, n_cid[0], n_cid[1], n_cid[2], c_id, n) - 1) % nc + 1

        # New-Order.
        tx_no = np.flatnonzero(kind == 0)
        m = len(tx_no)
        no_cust = pick_customer(m)
        no_cnt = rng.integers(5, MAX_LINES + 1, m)
        rolled = rng.random(m) < pub["new_order_rollback"]
        line_tx = np.repeat(np.arange(m), no_cnt)
        line_n = np.arange(len(line_tx)) - np.repeat(np.cumsum(no_cnt) - no_cnt, no_cnt) + 1
        item = (_nurand(rng, n_item[0], n_item[1], n_item[2], c_item, len(line_tx)) - 1) % ni + 1
        home = w[tx_no][line_tx]
        supply = np.where(rng.random(len(line_tx)) < pub["new_order_remote_line"], other(home), home)
        # Payment.
        tx_pay = np.flatnonzero(kind == 1)
        m = len(tx_pay)
        remote = rng.random(m) < pub["payment_remote"]
        pw = np.where(remote, other(w[tx_pay]), w[tx_pay])
        pd_ = np.where(remote, rng.integers(1, DISTRICTS + 1, m), d[tx_pay])
        by_name = rng.random(m) < pub["payment_by_last_name"]
        name = _nurand(rng, n_last[0], n_last[1], n_last[2], c_run, m) % min(1000, nc)
        q = ((pw - 1) * DISTRICTS + pd_ - 1) * 1000 + name
        lo = np.searchsorted(self._name_key, q, "left")
        hi = np.searchsorted(self._name_key, q, "right")
        named = self._by_name[np.minimum(lo + (hi - lo + 1) // 2 - 1, len(self._by_name) - 1)] % nc + 1
        pay_cust = np.where(by_name, named, pick_customer(m))

        # Order ids and deliveries, in commit order: a committed New-Order
        # takes its district's next id; a Delivery takes each district's
        # oldest undelivered order, if it has one.
        committed = tx_no[~rolled]
        com_k = (w[committed] - 1) * DISTRICTS + d[committed] - 1
        tx_dl = np.flatnonzero(kind == 3)
        events = sorted([(int(t_), 0, i) for i, t_ in enumerate(committed)]
                        + [(int(t_), 1, -1) for t_ in tx_dl])
        next_o = [no + 1] * nd
        head = [no - nn + 1] * nd
        com_o = np.zeros(len(committed), dtype=np.int64)
        com_k_l = com_k.tolist()
        w_l = w.tolist()
        dl = []  # (txn, district, order id)
        for t_, is_dl, i in events:
            if not is_dl:
                k = com_k_l[i]
                com_o[i] = next_o[k]
                next_o[k] += 1
                continue
            base = (w_l[t_] - 1) * DISTRICTS
            for dd in range(DISTRICTS):
                k = base + dd
                if head[k] < next_o[k]:
                    dl.append((t_, dd + 1, head[k]))
                    head[k] += 1
        self._next_o = np.array(next_o, dtype=np.int64)
        self._head = np.array(head, dtype=np.int64)
        # The orders' customers and line counts, by district and order id.
        cap = int(self._next_o.max())
        o_cust = np.zeros((nd, cap), dtype=np.int64)
        o_cnt = np.zeros((nd, cap), dtype=np.int64)
        o_cust[:, 1:no + 1] = self._o_cust
        o_cnt[:, 1:no + 1] = self._o_cnt
        keep = ~rolled
        o_cust[com_k, com_o] = no_cust[keep]
        o_cnt[com_k, com_o] = no_cnt[keep]
        self._o_cnt = o_cnt

        # The events. New-Order: order, new_order, lines, stock, district.
        cw, cd = w[committed], d[committed]
        self._emit("orders", committed, 0, np.stack([cw, cd, com_o], 1))
        self._emit("new_order", committed, 0, np.stack([cw, cd, com_o], 1))
        self._emit("district", committed, 0, np.stack([cw, cd], 1))
        line_keep = keep[line_tx]
        lt = line_tx[line_keep]
        com_index = np.cumsum(keep) - 1  # New-Order index -> committed index
        ci = com_index[lt]
        self._emit("order_line", tx_no[lt], line_n[line_keep],
                   np.stack([cw[ci], cd[ci], com_o[ci], line_n[line_keep]], 1))
        self._emit("stock", tx_no[lt], line_n[line_keep],
                   np.stack([supply[line_keep], item[line_keep]], 1))
        # Payment: warehouse, district, customer, history.
        self._emit("warehouse", tx_pay, 0, w[tx_pay][:, None])
        self._emit("district", tx_pay, 0, np.stack([w[tx_pay], d[tx_pay]], 1))
        self._emit("customer", tx_pay, 0, np.stack([pw, pd_, pay_cust], 1))
        self._emit("history", tx_pay, 0, None)
        # Delivery: new_order delete and tombstone, order, lines, customer.
        self.deliveries = len(dl)
        if dl:
            dl_a = np.array(dl, dtype=np.int64)
            dt, ddist, do = dl_a[:, 0], dl_a[:, 1], dl_a[:, 2]
            dw = w[dt]
            dk = (dw - 1) * DISTRICTS + ddist - 1
            key3 = np.stack([dw, ddist, do], 1)
            self._emit("new_order", dt, 2 * ddist, key3,
                       np.full(len(dt), self._delete_value("new_order")))
            self._emit("new_order", dt, 2 * ddist + 1, key3, np.full(len(dt), -1))
            self._emit("orders", dt, ddist, key3)
            self._emit("customer", dt, ddist, np.stack([dw, ddist, o_cust[dk, do]], 1))
            cnt = o_cnt[dk, do]
            lt = np.repeat(np.arange(len(dt)), cnt)
            ln = np.arange(len(lt)) - np.repeat(np.cumsum(cnt) - cnt, cnt) + 1
            self._emit("order_line", dt[lt], ddist[lt] * (MAX_LINES + 1) + ln,
                       np.stack([dw[lt], ddist[lt], do[lt], ln], 1))
        del self._by_name, self._name_key, self._o_cust

    # -- the table model -------------------------------------------------------

    def live_columns(self, table: str) -> "np.ndarray | None":
        """int64[rows, key columns]: the primary keys of the table model's
        live rows after the run (None for history, which has no key)."""
        W, nd, nc, ni = self.W, self.W * DISTRICTS, self.n_cust, self.n_items
        wd = np.stack([np.repeat(np.arange(1, W + 1), DISTRICTS),
                       np.tile(np.arange(1, DISTRICTS + 1), W)], 1)
        if table == "warehouse":
            return np.arange(1, W + 1)[:, None]
        if table == "district":
            return wd
        if table == "customer":
            return np.concatenate([np.repeat(wd, nc, 0), np.tile(np.arange(1, nc + 1), nd)[:, None]], 1)
        if table == "item":
            return np.arange(1, ni + 1)[:, None]
        if table == "stock":
            return np.stack([np.repeat(np.arange(1, W + 1), ni), np.tile(np.arange(1, ni + 1), W)], 1)
        if table == "history":
            return None
        lo = self._head if table == "new_order" else np.ones(nd, dtype=np.int64)
        n = self._next_o - lo
        k = np.repeat(np.arange(nd), n)
        o = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n) + np.repeat(lo, n)
        rows = np.concatenate([wd[k], o[:, None]], 1)
        if table != "order_line":
            return rows
        cnt = self._o_cnt[k, o]
        ln = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt) + 1
        return np.concatenate([np.repeat(rows, cnt, 0), ln[:, None]], 1)

    def live_rows(self, table: str) -> int:
        """Rows of the table model after the run (history: every row)."""
        if table == "history":
            return self.W * DISTRICTS * self.n_cust + self.counts["payment"]
        return len(self.live_columns(table))


def key_bytes(cols: np.ndarray, schema_id: int) -> np.ndarray:
    """uint8[N, 5 + 4 k]: the Confluent framing (magic 0, the key schema's
    id) and each key column as 4 bytes, big-endian."""
    n, k = cols.shape
    out = np.empty((n, KEY_FRAMING_BYTES + KEY_COLUMN_BYTES * k), dtype=np.uint8)
    out[:, 0] = 0
    out[:, 1:KEY_FRAMING_BYTES] = np.frombuffer(int(schema_id).to_bytes(4, "big"), dtype=np.uint8)
    out[:, KEY_FRAMING_BYTES:] = cols.astype(">u4").view(np.uint8).reshape(n, KEY_COLUMN_BYTES * k)
    return out


def expected_records(pub: dict, warehouses: int, transactions: int, scale: float) -> float:
    """The records of the nine topics a run is expected to write at
    ``scale`` (the mix's shares of ``transactions``; 10 lines an order)."""
    mix = pub["mix"]
    W, T = warehouses, transactions
    nd = W * DISTRICTS
    nc = pub["customers_per_district"] * scale
    no = pub["orders_per_district"] * scale
    nn = pub["new_orders_per_district"] * scale
    ni = pub["tables"]["item"]["rows"] * scale
    new = mix["new_order"] * (1 - pub["new_order_rollback"]) * T
    pay = mix["payment"] * T
    dl = mix["delivery"] * T * DISTRICTS
    return (W + pay + nd + new + pay + nd * nc + pay + dl + nd * nc + pay
            + nd * no + new + dl + nd * nn + new + 2 * dl
            + nd * no * 10 + new * 10 + dl * 10 + W * ni + new * 10 + ni)
