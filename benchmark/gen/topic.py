"""The records of a benchmark topic, drawn from its configuration and a seed.

A topic has ``partitions`` partitions. Each partition owns
``templates_per_partition`` template batches of ``records_per_batch``
records, and window ``w`` of partition ``p`` (offsets ``w * R`` to
``(w + 1) * R - 1``) is template ``w % T`` of that partition, its
``base_offset`` patched. So a partition's records repeat with a period of
``T * R`` records, and a key recurs no sooner than that within its
partition.

Per template position:

- keys: ``key_bytes`` printable bytes, distinct across the whole topic
  (the salt is the partition: key ids never repeat between partitions),
  drawn through a seeded bijection; no two partitions share an alive-key
  slot (the low ``slot_bits`` bits, default 32, of the analyzer's slot
  hash), so the alive count does not depend on the order in which
  partitions are folded. ``key_bytes: null``
  makes every key null.
- tombstones: exactly ``round(R * tombstone_share)`` records of each
  template carry a null value, at seeded positions.
- value sizes: one fixed multiset drawn from ``value_bytes`` (a beta
  distribution scaled to [min, max] with the given mean, and min and max
  each present), shared out over the non-tombstone records in a seeded
  order. Every seed gets the same sizes, so the work of a run does not
  depend on its seed.
- timestamps: ``BASE_TS_MS + t * R + i`` milliseconds for record ``i`` of
  template ``t``.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.hashes import fnv32_variant

#: 2020-01-01T00:00:00Z in ms: older than any run, so the report's
#: earliest timestamp is the topic's own and never the scan's start time.
BASE_TS_MS = 1_577_836_800_000
KEY_ALPHABET = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz234567", dtype=np.uint8)
_KEY_ID_BITS = 45  # 9 base-32 characters


class Topic:
    """The records of one configuration's topic under one seed."""

    def __init__(self, config: dict, seed: int, name: str = "bench"):
        t = config["topic"]
        self.name = name
        self.P = int(t["partitions"])
        self.R = int(t["records_per_batch"])
        self.T = int(t["templates_per_partition"])
        if t["records_per_partition"] % self.R:
            raise ValueError("records_per_partition must be whole batches")
        #: Windows per partition of the configuration's full topic.
        self.windows = t["records_per_partition"] // self.R
        self.brokers = int(t.get("brokers", 1))
        self.key_bytes = t.get("key_bytes")
        self.slot_bits = int(t.get("slot_bits", 32))
        self.seed = int(seed)
        rng = np.random.default_rng(self.seed)
        shape = (self.P, self.T, self.R)
        n_tomb = int(round(self.R * float(t.get("tombstone_share", 0.0))))
        tomb = np.zeros(shape, dtype=bool)
        if n_tomb:
            picks = np.argpartition(rng.random(shape), n_tomb - 1, axis=2)[:, :, :n_tomb]
            np.put_along_axis(tomb, picks, True, axis=2)
        sizes = value_size_multiset(t["value_bytes"], int((~tomb).sum()))
        #: int32[P, T, R] value bytes, -1 for a tombstone (null value).
        self.vlen = np.full(shape, -1, dtype=np.int32)
        self.vlen[~tomb] = rng.permutation(sizes)
        #: int64[T, R] record timestamps in ms (the same in every partition).
        self.ts_ms = (BASE_TS_MS + np.arange(self.T * self.R, dtype=np.int64)
                      ).reshape(self.T, self.R)
        #: uint8[P * T * R, key_bytes] keys in (p, t, i) order, or None.
        self.keys = None
        if self.key_bytes is not None:
            self.keys = self._draw_keys(rng)

    def _draw_keys(self, rng: np.random.Generator) -> np.ndarray:
        if self.key_bytes != 9:
            raise ValueError("keys are 9 base-32 characters (key_bytes 9)")
        n = self.P * self.T * self.R
        mask = (1 << _KEY_ID_BITS) - 1
        mult = int(rng.integers(1, 1 << (_KEY_ID_BITS - 1))) * 2 + 1
        add = int(rng.integers(0, 1 << _KEY_ID_BITS))

        def encode(ids: np.ndarray) -> np.ndarray:
            with np.errstate(over="ignore"):
                x = (ids.astype(np.uint64) * np.uint64(mult) + np.uint64(add)) & np.uint64(mask)
            out = np.empty((len(ids), 9), dtype=np.uint8)
            for j in range(9):
                out[:, j] = ((x >> np.uint64(5 * (8 - j))) & np.uint64(31)).astype(np.uint8)
            return KEY_ALPHABET[out]

        keys = encode(np.arange(n, dtype=np.int64))
        if self.P >= 1 << 16:
            raise ValueError("at most 65,535 keyed partitions")
        part = np.repeat(np.arange(self.P, dtype=np.int64), self.T * self.R)
        next_id = n
        while True:
            h = fnv32_variant(keys) & np.uint32((1 << self.slot_bits) - 1)
            order = np.argsort((h.astype(np.int64) << 16) | part)
            hs, ps = h[order], part[order]
            run_start = np.ones(n, dtype=bool)
            run_start[1:] = hs[1:] != hs[:-1]
            first_part = ps[run_start][np.cumsum(run_start) - 1]
            bad = order[ps != first_part]
            if not len(bad):
                return keys
            keys[bad] = encode(np.arange(next_id, next_id + len(bad), dtype=np.int64))
            next_id += len(bad)

    # -- the layout -----------------------------------------------------------

    def template_uses(self, heads: np.ndarray) -> np.ndarray:
        """int64[P, T]: how many windows below each partition's head use
        each template."""
        heads = np.asarray(heads, dtype=np.int64).reshape(self.P, 1)
        t = np.arange(self.T, dtype=np.int64).reshape(1, self.T)
        return heads // self.T + (t < heads % self.T)

    def last_window(self, heads: np.ndarray) -> np.ndarray:
        """int64[P, T]: the last window below each head that uses each
        template (-1 where none does)."""
        heads = np.asarray(heads, dtype=np.int64).reshape(self.P, 1)
        t = np.arange(self.T, dtype=np.int64).reshape(1, self.T)
        last = heads - 1 - ((heads - 1 - t) % self.T)
        return np.where(last >= 0, last, -1)


def value_size_multiset(spec: dict, n: int) -> np.ndarray:
    """The ``n`` value sizes every seed shares: a beta distribution scaled
    to [min, max] with the given mean (drawn from a fixed seed), with min
    and max each present once; or ``min`` alone where min == max."""
    lo, hi, mean = int(spec["min"]), int(spec["max"]), float(spec["mean"])
    if lo == hi:
        return np.full(n, lo, dtype=np.int32)
    a = float(spec["beta_a"])
    m = (mean - lo) / (hi - lo)
    b = a * (1.0 - m) / m
    x = np.random.default_rng(0).beta(a, b, size=n)
    sizes = (lo + np.rint(x * (hi - lo))).astype(np.int32)
    if n >= 2:
        sizes[0], sizes[1] = lo, hi
    return sizes
