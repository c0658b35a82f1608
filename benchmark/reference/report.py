"""The analyzer's report of a benchmark topic, computed plainly in numpy.

It works from the generator's records (`benchmark.gen.topic.Topic`: the
templates, the window layout) and the head of each partition, and imports
nothing of the program. Semantics (xenji/kafka-topic-analyzer's
``src/metric.rs``, the analyzer's ``--json`` document):

- per partition: records, tombstones (null values), ``alive`` (non-null
  values), null and non-null keys, key bytes of every keyed record, value
  bytes of every non-null value; ``dirty_ratio`` in float32 as
  ``tombstones / (total / 100)``; the three averages floored over
  ``alive``; start and end offsets.
- extremes: timestamps in whole seconds over every record; message sizes
  (key + value bytes) over non-tombstones only.
- ``-c``: alive keys are the slots of the 2^bits-slot bitmap (32 unless
  ``--alive-bitmap-bits`` says otherwise) whose last
  writer, in offset order, has a non-null value; a slot is the low bits of
  the key's ``fnv32_variant`` hash.
- HyperLogLog (p = 16): register ``h >> 48`` of ``h = splitmix64(fnv1a64(key))``
  takes the largest ``clz(h << 16) + 1`` (at most 49) over the keyed
  records; Ertl's improved raw estimator (2017, algorithm 6). The global
  estimate is of the registers' maximum over the partitions.
- DDSketch (alpha 0.005, 2,560 log buckets): a size ``s >= 1`` falls in
  bucket ``searchsorted(floor(gamma^i), s, 'left') + 1``; a quantile ``q``
  of ``n`` sizes is the bucket holding rank ``ceil(q * n)``, reported as
  ``2 gamma^(b-1) / (gamma + 1)``.

``lowp=True`` computes the same in 32-bit numbers where the program uses
64-bit ones (int32 counters, sums and millisecond timestamps, wrapping
as int32 does; float32 estimators): the benchmark's control, which its
comparison must reject.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.reference.hashes import fnv1a64, fnv32_variant, splitmix64

CHANNELS = ("total", "tombstones", "alive", "key_null", "key_non_null",
            "key_size_sum", "value_size_sum")
QUANTILE_PROBS = (0.5, 0.9, 0.99)
HLL_P = 16
ALIVE_BITS = 32
QUANTILE_ALPHA = 0.005
QUANTILE_BUCKETS = 2560


def features(argv: "list[str]") -> dict:
    """The report sections a CLI argument list asks for."""
    pp_hll = "--distinct-keys-per-partition" in argv
    pp_q = "--quantiles-per-partition" in argv
    bits = ALIVE_BITS
    if "--alive-bitmap-bits" in argv:
        bits = int(argv[argv.index("--alive-bitmap-bits") + 1])
    return {
        "alive_bits": bits,
        "alive": "-c" in argv or "--count-alive-keys" in argv,
        "hll": pp_hll or "--distinct-keys" in argv,
        "hll_per_partition": pp_hll,
        "quantiles": pp_q or "--quantiles" in argv,
        "quantiles_per_partition": pp_q,
    }


def _avg(total: int, alive: int) -> int:
    return total // alive if total > 0 and alive > 0 else 0


def _bit_length(x: np.ndarray) -> np.ndarray:
    """Bit length of each uint64, by halving."""
    x = x.astype(np.uint64, copy=True)
    n = np.zeros(x.shape, dtype=np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        big = x >= np.uint64(1 << s)
        n += np.where(big, s, 0)
        x = np.where(big, x >> np.uint64(s), x)
    return n + (x > 0)


def hll_registers(keys: np.ndarray, p: int = HLL_P) -> np.ndarray:
    regs = np.zeros(1 << p, dtype=np.uint8)
    if len(keys):
        h = splitmix64(fnv1a64(keys))
        idx = (h >> np.uint64(64 - p)).astype(np.int64)
        rest = h << np.uint64(p)
        rho = np.where(rest == 0, 64 - p + 1, 64 - _bit_length(rest) + 1)
        np.maximum.at(regs, idx, rho.astype(np.uint8))
    return regs


def hll_estimate(regs: np.ndarray, ftype=np.float64) -> float:
    """Ertl 2017, algorithm 6, with every float in ``ftype``."""
    m = regs.shape[0]
    q = 64 - (m.bit_length() - 1)
    c = np.bincount(regs.astype(np.int64), minlength=q + 2)
    one, half = ftype(1.0), ftype(0.5)

    def sigma(x):
        if x == one:
            return ftype(np.inf)
        y, z = one, x
        while True:
            x = x * x
            z_prev = z
            z = z + x * y
            y = y + y
            if z == z_prev:
                return z

    def tau(x):
        if x == ftype(0.0) or x == one:
            return ftype(0.0)
        y, z = one, one - x
        while True:
            x = np.sqrt(x)
            z_prev = z
            y = y * half
            z = z - (one - x) ** 2 * y
            if z == z_prev:
                return z / ftype(3.0)

    mf = ftype(m)
    z = mf * tau(one - ftype(c[q + 1]) / mf)
    for k in range(q, 0, -1):
        z = half * (z + ftype(c[k]))
    z = z + mf * sigma(ftype(c[0]) / mf)
    alpha = half / ftype(np.log(ftype(2.0)))
    return float(alpha * mf * mf / z)


def ddsketch_edges(ftype=np.float64) -> np.ndarray:
    gamma = ftype((1.0 + QUANTILE_ALPHA) / (1.0 - QUANTILE_ALPHA))
    powers = np.power(gamma, np.arange(QUANTILE_BUCKETS, dtype=ftype))
    return np.floor(np.minimum(powers.astype(np.float64), 2.0 ** 62)).astype(np.int64)


def quantiles(counts: np.ndarray, ftype=np.float64) -> "dict[str, float]":
    """``{str(q): value}`` of one row of bucket counts."""
    gamma = ftype((1.0 + QUANTILE_ALPHA) / (1.0 - QUANTILE_ALPHA))
    total = int(counts.sum())
    if total == 0:
        return {str(q): math.nan for q in QUANTILE_PROBS}
    cum = np.cumsum(counts)
    out = {}
    for q in QUANTILE_PROBS:
        rank = max(0, min(total - 1, int(np.ceil(q * total)) - 1))
        b = int(np.searchsorted(cum, rank + 1))
        if b == 0:
            out[str(q)] = 0.0
        elif b > QUANTILE_BUCKETS:
            out[str(q)] = math.inf
        else:
            out[str(q)] = float(ftype(2.0) * gamma ** ftype(b - 1) / (gamma + ftype(1.0)))
    return out


def reference_report(topic, heads, argv: "list[str]", lowp: bool = False) -> dict:
    """The report of partitions ``0..P-1`` read from offset 0 to
    ``heads[p] * R``, in the ``--json`` document's shape."""
    feats = features(argv)
    P, T, R = topic.P, topic.T, topic.R
    heads = np.asarray(heads, dtype=np.int64).reshape(P)
    ftype = np.float32 if lowp else np.float64
    uses = topic.template_uses(heads)
    vlen = topic.vlen.astype(np.int64)
    sized = vlen >= 0
    kb = 0 if topic.keys is None else topic.keys.shape[1]

    itype = np.int32 if lowp else np.int64

    def weighted(per_template: np.ndarray) -> np.ndarray:
        """Per-partition sum of a per-template count, in the run's type."""
        with np.errstate(over="ignore"):
            return (per_template.astype(itype) * uses.astype(itype)).sum(
                axis=1, dtype=itype).astype(np.int64)

    total = heads * R
    tomb = weighted((~sized).sum(axis=2))
    vsum = weighted(np.where(sized, vlen, 0).sum(axis=2))
    key_null = total if topic.keys is None else np.zeros(P, dtype=np.int64)
    key_non_null = total - key_null
    ksum = weighted(np.full((P, T), R * kb, dtype=np.int64))
    alive = total - tomb
    chans = np.stack([total, tomb, alive, key_null, key_non_null, ksum, vsum], axis=1)

    doc: dict = {"partitions": {}}
    used = uses > 0
    ts_s_lo = topic.ts_ms[:, 0].astype(itype).astype(np.int64) // 1000
    ts_s_hi = topic.ts_ms[:, -1].astype(itype).astype(np.int64) // 1000
    msg_lo = np.where(sized, vlen + kb, np.iinfo(np.int64).max).min(axis=2)
    msg_hi = np.where(sized, vlen + kb, -1).max(axis=2)
    extremes = {}
    for p in range(P):
        row = {name: int(chans[p, c]) for c, name in enumerate(CHANNELS)}
        t_, tb = row["total"], row["tombstones"]
        row["dirty_ratio"] = (
            float(np.float32(tb) / (np.float32(t_) / np.float32(100.0)))
            if t_ > 0 and tb > 0 else 0.0)
        row["key_size_avg"] = _avg(row["key_size_sum"], row["alive"])
        row["value_size_avg"] = _avg(row["value_size_sum"], row["alive"])
        row["message_size_avg"] = _avg(row["key_size_sum"] + row["value_size_sum"], row["alive"])
        row["start_offset"] = 0
        row["end_offset"] = int(heads[p] * R)
        doc["partitions"][str(p)] = row
        u = used[p]
        has_sized = bool((msg_hi[p][u] >= 0).any())
        extremes[str(p)] = {
            "earliest_ts": int(ts_s_lo[u].min()) if u.any() else None,
            "latest_ts": int(ts_s_hi[u].max()) if u.any() else None,
            "smallest": int(msg_lo[p][u].min()) if has_sized else None,
            "largest": int(msg_hi[p][u].max()) if has_sized else None,
        }
    doc["extremes_per_partition"] = extremes
    seen = [e for e in extremes.values() if e["earliest_ts"] is not None]
    smalls = [e["smallest"] for e in extremes.values() if e["smallest"] is not None]
    larges = [e["largest"] for e in extremes.values() if e["largest"] is not None]
    with np.errstate(over="ignore"):
        size_bytes = int((ksum.astype(itype) + vsum.astype(itype)).sum(dtype=itype))
    doc["overall"] = {
        "count": int(total.sum(dtype=itype)),
        "size_bytes": size_bytes,
        "earliest_ts": min(e["earliest_ts"] for e in seen) if seen else None,
        "latest_ts": max(e["latest_ts"] for e in seen) if seen else 0,
        "largest_message": max(larges) if larges else 0,
        "smallest_message": min(smalls) if smalls else 0,
    }

    if topic.keys is not None and (feats["alive"] or feats["hll"]):
        keys = topic.keys.reshape(P, T * R, kb)
        used_rec = np.repeat(used, R, axis=1)  # [P, T*R]
    if feats["alive"]:
        doc["alive_keys"] = 0
        if topic.keys is not None:
            last = topic.last_window(heads)  # [P, T]
            off = (last[:, :, None] * R + np.arange(R)).reshape(P, T * R)
            slot = (fnv32_variant(topic.keys).astype(np.int64)
                    & ((1 << feats["alive_bits"]) - 1)).reshape(P, T * R)
            flag = sized.reshape(P, T * R)
            pp, rr = np.nonzero(used_rec)
            comb = (pp << 32) | slot[pp, rr]
            val = off[pp, rr] * 2 + flag[pp, rr]
            order = np.argsort(comb, kind="stable")
            comb, val = comb[order], val[order]
            starts = np.flatnonzero(np.r_[True, comb[1:] != comb[:-1]])
            final = np.maximum.reduceat(val, starts) & 1
            slots = comb[starts] & ((1 << 32) - 1)
            # Slots the generator keeps apart never meet across partitions;
            # were one shared, it would count once if any last writer lived.
            alive_slots = np.unique(slots[final == 1])
            doc["alive_keys"] = int(len(alive_slots))
    if feats["hll"]:
        regs = np.zeros((P, 1 << HLL_P), dtype=np.uint8)
        if topic.keys is not None:
            for p in range(P):
                regs[p] = hll_registers(keys[p][used_rec[p]])
        doc["distinct_keys_hll"] = hll_estimate(regs.max(axis=0), ftype)
        if feats["hll_per_partition"]:
            doc["distinct_keys_hll_per_partition"] = {
                str(p): hll_estimate(regs[p], ftype) for p in range(P)}
    if feats["quantiles"]:
        nb = QUANTILE_BUCKETS + 2
        edges = ddsketch_edges(ftype)
        size = np.where(sized, vlen + kb, 0)
        bucket = np.searchsorted(edges, size, side="left") + 1
        bucket = np.where(size == 0, 0, bucket)
        weight = np.where(sized, uses[:, :, None], 0)
        counts = np.zeros((P, nb), dtype=np.int64)
        for p in range(P):
            counts[p] = np.bincount(bucket[p].reshape(-1), weights=weight[p].reshape(-1),
                                    minlength=nb).astype(np.int64)
        doc["size_quantiles"] = quantiles(counts.sum(axis=0), ftype)
        if feats["quantiles_per_partition"]:
            doc["size_quantiles_per_partition"] = {
                str(p): quantiles(counts[p], ftype) for p in range(P)}
    return doc
