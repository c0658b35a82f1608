"""Packed host→device batch transfer, wire formats v4 and v5 (port of
the reference's ``packing.py``: its numpy path, its native path through
the ingest shim, and the single-device fused sink).

One batch is one contiguous ``uint8`` row, sections in order (B = batch
size, P = partitions).  Wire v5, the combiner: every metric is an
associative per-partition fold, so the host reduces each batch to the
tables the device would have scattered it into:

    header    u8[16]      n_valid i32 | n_pairs i32 | reserved
    counts    i64[7P]     per-partition counter deltas, row-major [P, 7]
                          in results.COUNTER_CHANNELS order
    ts_minmax i64[2P]     per-partition ts min then max, identity-filled
    sz_minmax i64[2P]     per-partition message-size min then max
                          (tombstones excluded; identities I64_MAX / 0)
    [alive]   slot u32[B] + alive u8[B]   per-row pairs, compaction off
    [hll]     regs u8[R << p] host-reduced register table (R = 1 global,
              P per-partition) when R·2^p <= 3·B; else pairs: idx u16[B]
              + rho u8[B] globally, idx32 u32[B] (= partition << p |
              bucket) + rho u8[B] per-partition
    [quant]   i64[R·(nbuckets+2)]  DDSketch bucket-count deltas

Wire v4 ships the records' columns instead of the counts table, and the
device scatters them (9 B/record):

    header    u8[16]      as above
    partition i16[B]
    key_len   u16[B]      (keys > 64 KiB are rejected at pack time)
    value_len u32[B]
    flags     u8[B]       bit0 = key_null, bit1 = value_null
    ts_minmax, sz_minmax  as above
    [alive]   slot u32[B] + alive u8[B]   per-row pairs
    [hll]     the table, or idx u16[B] + rho u8[B] pairs (the device
              takes the row from the partition column)

With ``-c`` under v5 and compaction ``auto`` (`AnalyzerConfig.
compact_alive`) the alive pairs do not ride the row: each dispatch
carries ONE compacted pair-table buffer (`pack_pair_table`) — the host's
last-writer-wins merge of the dispatch's (slot, alive) pairs — as a
bounded pair list or as set/clear word masks (`alive_table_mode`).
Per-row pairs are the same last-writer-wins merge for one batch, with
their count in the header's ``n_pairs``.

The layout lives in one place, `_sections`: the packers and both
unpackers derive from it, and the bytes are identical to the reference's
packers for the same config (tests hold them together).  ``use_native``
packs through the shim (`io.native`) when it loads; its rows equal the
numpy rows except for the ORDER of alive pairs, which the native dedupe
emits first-touch and numpy by slot (the device result is order-free:
slots are unique), and for the columns of an invalid tail, which the shim
zeroes.  `FusedPackSink` appends single-partition column runs, and raw
Kafka record sets decoded in the same native pass, straight into a row,
with the same rows as the chained ``pack_batch``.

Device-side unpacking is ``Tensor.view(dtype)`` over byte slices; a
section whose offset is not a multiple of its item size (possible after a
1, 2 or 5 B/record section at an odd batch size) is copied first, since
``view`` needs an aligned offset.  u32/u16 sections come out as int32/int16 bit
patterns (`_torch_support`).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.io import native as _native
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.ops.ddsketch import (
    ddsketch_bucket_numpy,
    ddsketch_num_buckets,
)
from kafka_topic_analyzer_tpu_torch.ops.fnv import splitmix64_np
from kafka_topic_analyzer_tpu_torch.records import RecordBatch

HEADER_BYTES = 16
MAX_KEY_LEN = 0xFFFF
#: Dense partition indices must fit the reference's i16 section (and the
#: idx32 HLL pair form's 15 bits).
MAX_PARTITIONS = 0x7FFF
#: 16 MiB - 1: the reference's ``--pallas`` v4 kernel splits byte sums
#: into two 12-bit digits and rejects longer values at pack time.  The
#: port keeps the refusal for CLI parity; its own kernel is exact for any
#: int32 length.
MAX_VALUE_LEN = (1 << 24) - 1

#: numpy section dtype → the torch dtype its bytes are viewed as.
_TORCH_VIEW = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint16): torch.int16,
    np.dtype(np.uint32): torch.int32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}


def _sections(config: AnalyzerConfig, batch_size: int,
              pair_table: bool = False):
    """(name, dtype, count) section list, in buffer order.

    ``pair_table=True`` gives the layout of ONE compacted alive-pair table
    buffer instead, with ``batch_size`` then meaning the table capacity
    (`pair_table_capacity`)."""
    b = batch_size
    p = config.num_partitions
    if pair_table:
        if alive_table_mode(config, b) == 2:
            w = _alive_mask_words(config)
            return [
                ("alive_set", np.uint32, w),
                ("alive_clear", np.uint32, w),
            ]
        return [
            ("alive_slot", np.uint32, b),
            ("alive_flag", np.uint8, b),
        ]
    if config.wire_format == 5:
        sec = [("counts", np.int64, 7 * p)]
    else:
        sec = [
            ("partition", np.int16, b),
            ("key_len", np.uint16, b),
            ("value_len", np.uint32, b),
            ("flags", np.uint8, b),
        ]
    sec += [
        ("ts_minmax", np.int64, 2 * p),
        ("sz_minmax", np.int64, 2 * p),
    ]
    if config.count_alive_keys and not config.compact_alive:
        sec.append(("alive_slot", np.uint32, b))
        sec.append(("alive_flag", np.uint8, b))
    mode = hll_wire_mode(config, b)
    if mode == 2:
        sec.append(
            ("hll_regs", np.uint8, hll_table_rows(config, b) << config.hll_p)
        )
    elif mode == 3:
        sec.append(("hll_idx32", np.uint32, b))
        sec.append(("hll_rho", np.uint8, b))
    elif mode == 1:
        sec.append(("hll_idx", np.uint16, b))
        sec.append(("hll_rho", np.uint8, b))
    if config.wire_format == 5 and config.enable_quantiles:
        q_rows = p if config.quantiles_per_partition else 1
        sec.append(
            ("qcounts", np.int64,
             q_rows * ddsketch_num_buckets(config.quantile_buckets))
        )
    return sec


def hll_table_rows(config: AnalyzerConfig, batch_size: int) -> int:
    """Rows of the host-reduced HLL register table, or 0 for pair mode:
    the table costs ``R << hll_p`` bytes per batch against 3 B/record of
    pairs, and the smaller one ships."""
    rows = (
        config.num_partitions if config.distinct_keys_per_partition else 1
    )
    return rows if (rows << config.hll_p) <= 3 * batch_size else 0


def hll_wire_mode(config: AnalyzerConfig, batch_size: int) -> int:
    """The HLL section mode: ``0`` off, ``1`` u16 (bucket, rho) pairs,
    ``2`` register table, ``3`` flat u32 pairs (``partition << p |
    bucket``) for per-partition registers under wire v5, which has no
    partition column to take the row from."""
    if not config.enable_hll:
        return 0
    if hll_table_rows(config, batch_size):
        return 2
    if config.wire_format == 5 and config.distinct_keys_per_partition:
        return 3
    return 1


def packed_nbytes(config: AnalyzerConfig, batch_size: int) -> int:
    return HEADER_BYTES + sum(
        np.dtype(dt).itemsize * n for _, dt, n in _sections(config, batch_size)
    )


# ---------------------------------------------------------------------------
# host-side pre-reductions


#: Sections whose byte count scales with the batch size — the per-record
#: share of a packed row.  Everything else (header included) is a
#: fold-table constant per row.  Drives `section_byte_split` and the
#: ``--stats`` wire line.
PER_RECORD_SECTIONS = frozenset(
    {"partition", "key_len", "value_len", "flags",
     "alive_slot", "alive_flag", "hll_idx", "hll_idx32", "hll_rho"}
)


def section_byte_split(
    config: AnalyzerConfig, batch_size: int
) -> "Tuple[int, int]":
    """(per_record_bytes, fold_table_bytes) of one packed row — the
    fold-table share includes the header; the two sum to
    `packed_nbytes`."""
    per_record = 0
    table = HEADER_BYTES
    for name, dtype, count in _sections(config, batch_size):
        nbytes = np.dtype(dtype).itemsize * count
        if name in PER_RECORD_SECTIONS:
            per_record += nbytes
        else:
            table += nbytes
    return per_record, table


def dedupe_slots_numpy(
    h32: np.ndarray, active: np.ndarray, alive: np.ndarray, bits: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Last-writer-wins (slot, aliveness) pairs: replaying insert/remove
    in record order, only each slot's last record survives."""
    slot = (h32.astype(np.uint64) & np.uint64((1 << bits) - 1)).astype(np.uint32)
    slot = slot[active]
    alive = alive[active]
    if len(slot) == 0:
        return slot, alive.astype(np.uint8)
    uniq, first_rev = np.unique(slot[::-1], return_index=True)
    return uniq.astype(np.uint32), alive[::-1][first_rev].astype(np.uint8)


def _dedupe_slots(h32, active, alive, bits, use_native=False):
    if use_native and _native.native_available():
        return _native.dedupe_slots_native(h32, active, alive, bits)
    return dedupe_slots_numpy(h32, active, alive, bits)


def hll_idx_rho_numpy(
    h64: np.ndarray, active: np.ndarray, p: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pre-split HLL updates: (bucket index, rho).  Inactive records get
    bucket 0 with rho 0 — a no-op under scatter-max."""
    h = splitmix64_np(h64.astype(np.uint64))
    idx = (h >> np.uint64(64 - p)).astype(np.uint16)
    rest = (h << np.uint64(p)) & np.uint64((1 << 64) - 1)
    # rho = clz(rest) + 1, capped at 64 - p + 1 when rest == 0; clz via a
    # hi/lo split so float64 log2 stays exact.
    rho = np.full(h.shape, 64 - p + 1, dtype=np.uint8)
    nz = rest != 0
    hi = (rest >> np.uint64(32)).astype(np.uint32)
    lo = (rest & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    clz_hi = 31 - np.floor(np.log2(np.maximum(hi, 1).astype(np.float64))).astype(np.int32)
    clz_lo = 63 - np.floor(np.log2(np.maximum(lo, 1).astype(np.float64))).astype(np.int32)
    clz = np.where(hi != 0, clz_hi, np.where(lo != 0, clz_lo, 64)).astype(np.int32)
    rho[nz] = (clz[nz] + 1).astype(np.uint8)
    idx = np.where(active, idx, np.uint16(0))
    rho = np.where(active, rho, np.uint8(0))
    return idx.astype(np.uint16), rho


# ---------------------------------------------------------------------------
# compacted alive-pair table


def pair_table_capacity(config: AnalyzerConfig, batch_size: int,
                        k: int = 1) -> int:
    """Capacity of one dispatch's pair table: a dispatch of ``k`` rows
    folds at most ``k * batch_size`` records and distinct slots cannot
    exceed the slot space, so ``min(k·B, 2^bits)`` bounds the merge with
    no overflow path."""
    return min(int(k) * int(batch_size), 1 << config.alive_bitmap_bits)


#: Mask-form cap: set/clear word masks may grow to at most this many bytes
#: per dispatch; past it the pair list is the bounded form (the
#: reference-exact 2^32 slot space stays on pairs).
ALIVE_MASK_CAP_BYTES = 64 << 20
#: Masks may cost up to this many times the pair list's wire bytes.
ALIVE_MASK_TRADE_FACTOR = 32


def _alive_mask_words(config: AnalyzerConfig) -> int:
    return 1 << max(config.alive_bitmap_bits - 5, 0)


def alive_table_mode(config: AnalyzerConfig, capacity: int) -> int:
    """The compacted table's form: ``1`` = bounded pair list ``slot
    u32[T] | flag u8[T]`` (device scatter), ``2`` = set/clear word masks
    ``u32[W] | u32[W]`` (elementwise device merge)."""
    mask_nbytes = 2 * _alive_mask_words(config) * 4
    if mask_nbytes <= min(
        ALIVE_MASK_TRADE_FACTOR * 5 * capacity, ALIVE_MASK_CAP_BYTES
    ):
        return 2
    return 1


def pair_table_nbytes(config: AnalyzerConfig, capacity: int) -> int:
    return HEADER_BYTES + sum(
        np.dtype(dt).itemsize * n
        for _, dt, n in _sections(config, capacity, pair_table=True)
    )


def batch_alive_pairs(
    batch: RecordBatch, config: AnalyzerConfig, use_native: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """One batch's LWW-deduped (slot, alive) pairs."""
    active = batch.valid & ~batch.key_null
    alive = batch.valid & ~batch.value_null
    return _dedupe_slots(
        batch.key_hash32, active, alive, config.alive_bitmap_bits, use_native
    )


def _pairs_to_masks_numpy(
    slots: np.ndarray, flags: np.ndarray, bits: int
) -> "tuple[np.ndarray, np.ndarray]":
    """Set/clear word masks from DEDUPED (unique-slot) pairs."""
    w_words = 1 << max(bits - 5, 0)
    set_w = np.zeros(w_words, dtype=np.uint32)
    clear_w = np.zeros(w_words, dtype=np.uint32)
    if len(slots):
        order = np.argsort(slots, kind="stable")
        s = slots[order]
        f = flags[order].astype(bool)
        for subset, mask_out in ((f, set_w), (~f, clear_w)):
            ss = s[subset]
            if not len(ss):
                continue
            w = (ss >> np.uint32(5)).astype(np.int64)
            b = np.uint32(1) << (ss & np.uint32(31))
            starts = np.flatnonzero(np.r_[True, w[1:] != w[:-1]])
            mask_out[w[starts]] = np.bitwise_or.reduceat(b, starts)
    return set_w, clear_w


def pack_pair_table(
    pair_lists,
    config: AnalyzerConfig,
    capacity: int,
    use_native: bool = False,
    out: "np.ndarray | None" = None,
) -> "tuple[np.ndarray, int, int]":
    """LWW-merge per-batch pair lists, in stream order, into one packed
    pair-table buffer (header + the ``pair_table`` sections of
    `_sections`).  Returns ``(buffer, raw_pairs, emitted_pairs)``; in the
    mask form "emitted" counts the distinct slots touched.  With
    ``use_native`` the shim applies the raw stream straight to the masks,
    or dedupes the list form (first-touch order)."""
    parts = [
        (np.ascontiguousarray(s, dtype=np.uint32),
         np.ascontiguousarray(f, dtype=np.uint8))
        for s, f in pair_lists
        if len(s)
    ]
    if parts:
        slots = np.concatenate([p[0] for p in parts])
        flags = np.concatenate([p[1] for p in parts])
    else:
        slots = np.empty(0, dtype=np.uint32)
        flags = np.empty(0, dtype=np.uint8)
    raw = len(slots)
    nbytes = pair_table_nbytes(config, capacity)
    if out is None:
        out = np.empty(nbytes, dtype=np.uint8)
    elif out.shape != (nbytes,) or out.dtype != np.uint8:
        raise ValueError("pack_pair_table out= must be uint8[nbytes]")
    secs = {}
    pos = HEADER_BYTES
    for name, dtype, count in _sections(config, capacity, pair_table=True):
        nb = np.dtype(dtype).itemsize * count
        secs[name] = out[pos : pos + nb].view(dtype)
        pos += nb
    bits = config.alive_bitmap_bits
    if alive_table_mode(config, capacity) == 2 and raw and use_native \
            and _native.native_available():
        # Mask form from the raw stream in one native pass.
        n = _native.pairs_to_masks_native(
            slots, flags, bits, secs["alive_set"], secs["alive_clear"]
        )
    else:
        merged_slots, merged_flags = (
            _dedupe_slots(slots, np.ones(raw, dtype=bool), flags, bits, use_native)
            if raw else (slots, flags)
        )
        n = len(merged_slots)
        if alive_table_mode(config, capacity) == 2:
            secs["alive_set"][:], secs["alive_clear"][:] = _pairs_to_masks_numpy(
                merged_slots, merged_flags, bits
            )
        else:
            if n > capacity:
                raise AssertionError(
                    f"pair-table overflow: {n} merged pairs > capacity {capacity}"
                )
            secs["alive_slot"][:n] = merged_slots
            secs["alive_slot"][n:] = 0
            secs["alive_flag"][:n] = merged_flags
            secs["alive_flag"][n:] = 0
    header = np.zeros(4, dtype=np.int32)
    header[1] = n
    out[:HEADER_BYTES] = header.view(np.uint8)
    return out, raw, n


def unpack_pair_table_numpy(
    buf: np.ndarray, config: AnalyzerConfig, capacity: int
) -> Dict[str, np.ndarray]:
    """Host-side reference unpack of a pair-table buffer."""
    out: Dict[str, np.ndarray] = {
        "n_pairs": buf[:HEADER_BYTES].view(np.int32)[1]
    }
    pos = HEADER_BYTES
    for name, dtype, count in _sections(config, capacity, pair_table=True):
        nb = np.dtype(dtype).itemsize * count
        out[name] = buf[pos : pos + nb].view(dtype)
        pos += nb
    return out


# ---------------------------------------------------------------------------
# pack (host)


I64_MAX = np.iinfo(np.int64).max
I64_MIN = np.iinfo(np.int64).min


def ts_minmax_table(partition: np.ndarray, ts_s: np.ndarray,
                    num_partitions: int) -> np.ndarray:
    """Per-partition ts reduction: ``[2P]`` int64, mins then maxes,
    identity-filled for partitions absent from the (valid-prefix) input."""
    table = np.empty(2 * num_partitions, dtype=np.int64)
    table[:num_partitions] = I64_MAX
    table[num_partitions:] = I64_MIN
    if len(partition):
        np.minimum.at(table[:num_partitions], partition, ts_s)
        np.maximum.at(table[num_partitions:], partition, ts_s)
    return table


def sz_minmax_table(batch: RecordBatch, n_valid: int,
                    num_partitions: int) -> np.ndarray:
    """Per-partition message-size extremes: ``[2P]`` int64, mins then
    maxes.  Size = key bytes (when non-null) + value bytes; tombstones are
    excluded.  Identities are I64_MAX / 0 (the reference's ``largest``
    starts at 0)."""
    table = np.empty(2 * num_partitions, dtype=np.int64)
    table[:num_partitions] = I64_MAX
    table[num_partitions:] = 0
    sized = ~batch.value_null[:n_valid]
    if sized.any():
        part = batch.partition[:n_valid][sized]
        size = (
            np.where(batch.key_null[:n_valid], 0,
                     batch.key_len[:n_valid]).astype(np.int64)
            + batch.value_len[:n_valid].astype(np.int64)
        )[sized]
        np.minimum.at(table[:num_partitions], part, size)
        np.maximum.at(table[num_partitions:], part, size)
    return table


def _combiner_tables(
    batch: RecordBatch, n_valid: int, config: AnalyzerConfig
) -> Dict[str, np.ndarray]:
    """The wire-v5 combiner reduction: the per-partition delta tables the
    device would have scattered the batch's records into."""
    part = batch.partition[:n_valid]
    kn = ~batch.key_null[:n_valid]
    vn = ~batch.value_null[:n_valid]
    k_bytes = np.where(kn, batch.key_len[:n_valid], 0).astype(np.int64)
    v_bytes = np.where(vn, batch.value_len[:n_valid], 0).astype(np.int64)
    counts = np.zeros((config.num_partitions, 7), dtype=np.int64)
    if n_valid:
        contrib = np.stack(
            [
                np.ones(n_valid, dtype=np.int64),
                (~vn).astype(np.int64),  # tombstones
                vn.astype(np.int64),     # alive
                (~kn).astype(np.int64),  # key_null
                kn.astype(np.int64),     # key_non_null
                k_bytes,
                v_bytes,
            ],
            axis=1,
        )
        np.add.at(counts, part, contrib)
    out = {"counts": counts.reshape(-1)}
    if config.enable_quantiles:
        nb = ddsketch_num_buckets(config.quantile_buckets)
        q_rows = config.num_partitions if config.quantiles_per_partition else 1
        qtable = np.zeros(q_rows * nb, dtype=np.int64)
        if n_valid and vn.any():
            # Quantiles run over sized (non-tombstone) messages.
            sizes = (k_bytes + v_bytes)[vn]
            idx = ddsketch_bucket_numpy(
                sizes, config.quantile_gamma, config.quantile_buckets
            )
            if q_rows > 1:
                idx = part[vn].astype(np.int64) * nb + idx
            np.add.at(qtable, idx, 1)
        out["qcounts"] = qtable
    return out


def pack_batch(
    batch: RecordBatch,
    config: AnalyzerConfig,
    use_native: bool = False,
    out: "np.ndarray | None" = None,
) -> np.ndarray:
    """RecordBatch → one contiguous ``uint8`` row in the config's wire
    format (the module docstring is the layout).  Valid records must be a
    prefix of the batch.  ``use_native`` packs in one C++ pass when the
    shim loads.  ``out`` packs into a caller-provided
    ``uint8[packed_nbytes]`` buffer (a pinned staging row); every byte of
    it is overwritten."""
    b = config.batch_size
    n = len(batch)
    if n > b:
        raise ValueError(f"batch of {n} exceeds batch_size {b}")
    n_valid = batch.num_valid
    if n_valid and not bool(batch.valid[:n_valid].all()):
        raise ValueError("packed transfer requires prefix-valid batches")
    if batch.key_len.max(initial=0) > MAX_KEY_LEN:
        raise ValueError(
            f"key length {int(batch.key_len.max())} exceeds the packed "
            f"transfer limit of {MAX_KEY_LEN} bytes"
        )
    if n and (
        batch.partition.max(initial=0) > MAX_PARTITIONS or batch.partition.min() < 0
    ):
        raise ValueError(
            f"partition index out of packed-transfer range [0, {MAX_PARTITIONS}]"
        )
    if n_valid and batch.partition[:n_valid].max() >= config.num_partitions:
        raise ValueError(
            f"partition index {int(batch.partition[:n_valid].max())} >= "
            f"num_partitions {config.num_partitions}"
        )
    if n and (batch.value_len.min() < 0 or batch.key_len.min() < 0):
        raise ValueError("negative key/value length in record batch")
    if (
        config.use_pallas_counters
        and config.wire_format == 4
        and batch.value_len.max(initial=0) > MAX_VALUE_LEN
    ):
        raise ValueError(
            f"value length {int(batch.value_len.max())} exceeds the Pallas "
            f"counter kernel's limit of {MAX_VALUE_LEN} bytes — disable "
            f"use_pallas_counters for such topics"
        )

    if use_native and _native.native_available():
        packed = _native.pack_batch_native(batch, config, out=out)
        if packed is not None:
            return packed
        # The shim rejected a value; the numpy path below says which.

    nbytes = packed_nbytes(config, b)
    if out is None:
        out = np.empty(nbytes, dtype=np.uint8)
    elif out.shape != (nbytes,) or out.dtype != np.uint8:
        raise ValueError("pack_batch out= must be uint8[packed_nbytes]")
    header = np.zeros(4, dtype=np.int32)
    header[0] = n_valid

    fields: Dict[str, np.ndarray] = {
        "ts_minmax": ts_minmax_table(
            batch.partition[:n_valid], batch.ts_s[:n_valid],
            config.num_partitions,
        ),
        "sz_minmax": sz_minmax_table(batch, n_valid, config.num_partitions),
    }
    if config.wire_format == 5:
        fields.update(_combiner_tables(batch, n_valid, config))
    else:
        # Integer columns go in uncast: the section write narrows them
        # through a typed view (the range checks above make it lossless).
        fields.update(
            partition=batch.partition,
            key_len=batch.key_len,
            value_len=batch.value_len,
            flags=(batch.key_null.astype(np.uint8)
                   | (batch.value_null.astype(np.uint8) << 1)),
        )
    if config.count_alive_keys and not config.compact_alive:
        slots, flags = batch_alive_pairs(batch, config)
        header[1] = len(slots)
        fields["alive_slot"] = slots
        fields["alive_flag"] = flags
    if config.enable_hll:
        active = batch.valid & ~batch.key_null
        idx, rho = hll_idx_rho_numpy(batch.key_hash64, active, config.hll_p)
        mode = hll_wire_mode(config, b)
        if mode == 2:
            rows = hll_table_rows(config, b)
            table = np.zeros(rows << config.hll_p, dtype=np.uint8)
            if n_valid:
                flat = idx[:n_valid].astype(np.int64)
                if rows > 1:
                    flat = flat + (
                        batch.partition[:n_valid].astype(np.int64)
                        << config.hll_p
                    )
                np.maximum.at(table, flat, rho[:n_valid])
            fields["hll_regs"] = table
        elif mode == 3:
            fields["hll_idx32"] = np.where(
                active,
                (batch.partition.astype(np.int64) << config.hll_p)
                | idx.astype(np.int64),
                0,
            ).astype(np.uint32)
            fields["hll_rho"] = rho
        else:
            fields["hll_idx"] = idx
            fields["hll_rho"] = rho

    out[:HEADER_BYTES] = header.view(np.uint8)
    pos = HEADER_BYTES
    for name, dtype, count in _sections(config, b):
        nbytes = np.dtype(dtype).itemsize * count
        src = fields[name]
        sec = out[pos : pos + nbytes].view(dtype)
        sec[: len(src)] = src
        sec[len(src):] = 0  # tail padding past the batch's rows
        pos += nbytes
    return out


def pack_chunks(
    batch: RecordBatch,
    chunk_config: AnalyzerConfig,
    space_shards: int,
    use_native: bool = False,
    out: "np.ndarray | None" = None,
) -> np.ndarray:
    """One data row's batch packed into its ``space_shards`` contiguous
    record chunks: ``uint8[S, chunk_nbytes]``, chunk ``s`` holding records
    ``[s*C, (s+1)*C)`` (``C = chunk_config.batch_size``), each packed with
    the chunk config (whose batch size decides the HLL wire mode and so
    the sections).  Contiguity makes the mesh's ordered alive apply exact:
    chunk order is record order (backends/step.py).  The one chunking
    rule of the sharded backend; ``out`` packs into the caller's
    ``[S, chunk_nbytes]`` rows."""
    c = chunk_config.batch_size
    n = len(batch)
    if n > c * space_shards:
        raise ValueError(f"batch of {n} exceeds batch_size {c * space_shards}")
    nbytes = packed_nbytes(chunk_config, c)
    if out is None:
        out = np.empty((space_shards, nbytes), dtype=np.uint8)
    elif out.shape != (space_shards, nbytes) or out.dtype != np.uint8:
        raise ValueError(
            f"pack_chunks out buffer must be uint8[{space_shards}, "
            f"{nbytes}], got {out.dtype}{list(out.shape)}"
        )
    for s in range(space_shards):
        lo = s * c
        pack_batch(
            batch.take(np.arange(lo, min(lo + c, n))),
            chunk_config,
            use_native=use_native,
            out=out[s],
        )
    return out


def unpack_numpy(buf: np.ndarray, config: AnalyzerConfig) -> Dict[str, np.ndarray]:
    """Host-side reference unpack (the device self-check's oracle)."""
    header = buf[:HEADER_BYTES].view(np.int32)
    out: Dict[str, np.ndarray] = {"n_valid": header[0], "n_pairs": header[1]}
    pos = HEADER_BYTES
    for name, dtype, count in _sections(config, config.batch_size):
        nbytes = np.dtype(dtype).itemsize * count
        out[name] = buf[pos : pos + nbytes].view(dtype)
        pos += nbytes
    if config.wire_format == 4:
        flags = out.pop("flags")
        out["key_null"] = (flags & 1).astype(bool)
        out["value_null"] = (flags & 2).astype(bool)
        out["valid"] = np.arange(config.batch_size, dtype=np.int32) < out["n_valid"]
        for name in ("partition", "key_len", "value_len"):
            out[name] = out[name].astype(np.int32)
    return _shape_tables(out, config)


# ---------------------------------------------------------------------------
# unpack (device)


def _view(section: torch.Tensor, dtype) -> torch.Tensor:
    """Typed view of a byte slice; misaligned slices are copied first."""
    tdtype = _TORCH_VIEW[np.dtype(dtype)]
    if tdtype == torch.uint8:
        return section
    if section.storage_offset() % np.dtype(dtype).itemsize:
        section = section.clone()
    return section.view(tdtype)


def _shape_tables(out: dict, config: AnalyzerConfig) -> dict:
    p = config.num_partitions
    if "counts" in out:
        out["counts"] = out["counts"].reshape(p, 7)
    if "qcounts" in out:
        out["qcounts"] = out["qcounts"].reshape(
            -1, ddsketch_num_buckets(config.quantile_buckets)
        )
    tm = out.pop("ts_minmax")
    out["ts_min"], out["ts_max"] = tm[:p], tm[p:]
    sm = out.pop("sz_minmax")
    out["sz_min"], out["sz_max"] = sm[:p], sm[p:]
    return out


def unpack_device(buf: torch.Tensor, config: AnalyzerConfig) -> dict:
    """``uint8[packed_nbytes]`` tensor → dict of typed tensors on its
    device (views where aligned).  Wire-v4 columns come out as the
    reference's: int32 partition, key and value lengths, bool flags, and
    ``valid = arange(B) < n_valid`` against the header's device scalar
    (no device→host sync)."""
    header = _view(buf[:HEADER_BYTES], np.int32)
    out = {"n_valid": header[0], "n_pairs": header[1]}
    pos = HEADER_BYTES
    for name, dtype, count in _sections(config, config.batch_size):
        nbytes = np.dtype(dtype).itemsize * count
        out[name] = _view(buf[pos : pos + nbytes], dtype)
        pos += nbytes
    if config.wire_format == 4:
        flags = out.pop("flags")
        out["key_null"] = (flags & 1).to(torch.bool)
        out["value_null"] = (flags & 2).to(torch.bool)
        out["valid"] = (
            torch.arange(config.batch_size, device=buf.device) < out["n_valid"]
        )
        out["partition"] = out["partition"].to(torch.int32)
        # The u16 bit pattern read as int16 goes negative from 32 KiB up.
        out["key_len"] = out["key_len"].to(torch.int32) & 0xFFFF
    return _shape_tables(out, config)


def unpack_pair_table_device(
    buf: torch.Tensor, config: AnalyzerConfig, capacity: int
) -> dict:
    """``uint8[pair_table_nbytes]`` tensor → typed tensors — the pair-table
    twin of `unpack_device`."""
    out = {"n_pairs": _view(buf[:HEADER_BYTES], np.int32)[1]}
    pos = HEADER_BYTES
    for name, dtype, count in _sections(config, capacity, pair_table=True):
        nb = np.dtype(dtype).itemsize * count
        out[name] = _view(buf[pos : pos + nb], dtype)
        pos += nb
    return out


# ---------------------------------------------------------------------------
# fused sink: columns appended straight into rows


#: Decoded bytes per record (the RecordBatch column widths): a PackedRow
#: reports the size of the decoded batch it stands for.
_RECORD_NBYTES = sum(np.dtype(dt).itemsize for _, dt in RecordBatch.FIELDS)


def fused_ingest_enabled() -> bool:
    """Master gate for fused rows: the shim must load (its incremental
    packer fills them) and the ``KTA_DISABLE_FUSED`` kill switch must be
    unset.  A closed gate keeps the chained path, booked by the engine."""
    if os.environ.get("KTA_DISABLE_FUSED"):
        return False
    return _native.native_available()


class PackedRow:
    """One completed row from a `FusedPackSink`, with what the engine
    would otherwise read off the decoded batch: its record count, each
    partition's progress (one past the last offset for sources that carry
    offsets, else a count), and the last record's identity.  ``staged``
    is the backend's staged form when the sink has a stage callback (it
    runs on the producing thread, as ``prepare`` does on the chained
    path); ``pairs`` are the row's compacted alive pairs in stream order
    (None unless the config compacts them)."""

    __slots__ = (
        "buf", "staged", "n_valid", "next_offsets", "counts",
        "last_partition", "last_offset", "last_ts_s", "pairs",
    )

    def __init__(self, buf, staged, n_valid, next_offsets, counts,
                 last_partition, last_offset, last_ts_s, pairs=None):
        self.buf = buf
        self.staged = staged
        self.n_valid = n_valid
        self.next_offsets = next_offsets
        self.counts = counts
        self.last_partition = last_partition
        self.last_offset = last_offset
        self.last_ts_s = last_ts_s
        self.pairs = pairs

    @property
    def num_valid(self) -> int:
        return self.n_valid

    @property
    def nbytes(self) -> int:
        return self.n_valid * _RECORD_NBYTES


#: The reference's ``kta_fused_fallback_total`` label of a fused sink's
#: fallback reason: the decoder the frame went through.  Frames the Python
#: decoder took (legacy message sets, v2 frames the native decoder
#: refused) read ``python-decode``; every other reason (``compressed``,
#: ``salvaged``, ``frame-fallback``: native per-frame decodes) reads
#: ``frame-fallback``.
FALLBACK_LABEL = {"legacy": "python-decode", "python-decode": "python-decode"}


class SuperbatchStager:
    """Pinned host staging for the one buffer a dispatch assembles on the
    main thread.

    The reference stacks a superbatch's K rows into one ``uint8[K, N]``
    array and ships it in one transfer.  The single-device backend does
    not: each row has already left its ingest stream's staging slot
    through its own asynchronous copy, so what is left to stage per
    dispatch is the table `pack_pair_table` merges from the K rows' raw
    pairs.  The sharded backend (parallel/sharded.py) does: a slot holds
    the K rounds' chunk stacks, ``[K, rows, S, chunk_nbytes]``, and under
    compaction each data row's merged pair table behind them, and leaves
    in one copy.  The stager owns a ring of ``depth + 1`` such buffers (pinned when
    ``pin``), so assembling superbatch ``i`` never allocates and never
    overwrites a buffer whose copy may still be in flight: the slot
    reused was last dispatched as superbatch ``i - depth - 1``, which the
    dispatch queue (backends/base.py::DispatchQueue) retired before
    dispatch ``i`` could pass its throttle.  ``record(slot, event)``
    keeps the event recorded behind a slot's copy too, and `next_slot`
    waits on it, so the ring stays safe without that argument."""

    def __init__(self, nbytes: int, depth: int, pin: bool = False,
                 book: bool = True):
        if depth < 1:
            raise ValueError("dispatch depth must be >= 1")
        self.hosts = [
            torch.empty(int(nbytes), dtype=torch.uint8, pin_memory=pin)
            for _ in range(depth + 1)
        ]
        self.views = [host.numpy() for host in self.hosts]
        self._events: list = [None] * len(self.hosts)
        self._next = 0
        self._book = book

    def next_slot(self) -> int:
        """The index of the buffer to assemble the next superbatch's
        table into (`hosts`/`views`), once its last copy completed."""
        slot = self._next
        self._next = (slot + 1) % len(self.hosts)
        if self._events[slot] is not None:
            self._events[slot].synchronize()
            self._events[slot] = None
        # Ring activity for the flight recorder: the hand-out rate is the
        # superbatch assembly rate (``book``: the stager serves
        # superbatches, as the reference's only does).
        if self._book:
            obs_metrics.STAGER_SLOTS.inc()
        return slot

    def record(self, slot: int, event) -> None:
        """Remember the event that completes with ``slot``'s last copy."""
        self._events[slot] = event


class FusedPackSink:
    """Incremental row assembly for one ingest stream.

    Single-device form (``space_shards`` 1): rows are flat
    ``uint8[packed_nbytes]`` buffers of ``chunk_records`` records.  Rows
    fill greedily across appends and partitions, so a row equals
    ``pack_batch`` over the same records cut at ``chunk_records``
    boundaries.

    Sharded form (``space_shards`` S > 1 with the backend's chunk
    config): rows are ``uint8[S, chunk_nbytes]`` — records fill
    chunk 0..S-1 at ``chunk_records`` each, the `pack_chunks` rule, so a
    fused row is what the sharded backend's ``prepare_shard`` would have
    staged.  ``dense_of`` maps a true partition id to its state row.
    ``alloc`` returns the buffer the next row is packed into (a pinned
    staging slot; a fresh array by default); ``stage(row[, pairs])`` turns
    a completed row into the backend's staged form.  Not thread-safe: one
    sink per stream, fed in per-partition offset order.

    ``fallbacks`` counts, by reason, the records a Kafka stream could not
    decode→pack in one pass (compressed, legacy or salvaged frames, v2
    frames only the Python decoder takes, and other frames past a record
    set's native prefix) and so appended as
    decoded batches (`append_batch`); a stream that drops the sink
    altogether books one under ``native-*``."""

    def __init__(self, pack_config: AnalyzerConfig, chunk_records: int,
                 dense_of, stage=None, alloc=None, space_shards: int = 1):
        self.pack_config = pack_config
        self.chunk_records = int(chunk_records)
        self.space_shards = int(space_shards)
        self._chunked = self.space_shards > 1
        self._dense_of = dense_of
        self._stage = stage
        self._nbytes = packed_nbytes(pack_config, self.chunk_records)
        shape = (
            (self.space_shards, self._nbytes) if self._chunked else self._nbytes
        )
        self._alloc = alloc or (lambda: np.empty(shape, dtype=np.uint8))
        self._scratch = np.zeros(
            _native.pack_scratch_len(pack_config, self.chunk_records),
            dtype=np.int64,
        )
        self._row: "np.ndarray | None" = None
        self._chunk = 0
        self._count = 0
        self._next_offsets: "dict[int, int]" = {}
        self._counts: "dict[int, int]" = {}
        self._last = (-1, -1, 0)
        self._done: "list[PackedRow]" = []
        #: Under compaction the native pass diverts each row's LWW pairs
        #: to the scratch's emission region; they are copied out before
        #: any re-init of the scratch.
        self._compact = pack_config.compact_alive
        self._row_pairs: "list[tuple[np.ndarray, np.ndarray]]" = []
        self.fallbacks: "dict[str, int]" = {}

    def _out_chunk(self) -> np.ndarray:
        return self._row[self._chunk] if self._chunked else self._row

    def _ensure_row(self) -> None:
        if self._row is None:
            self._row = self._alloc()
            self._chunk = 0
            self._count = 0
            self._next_offsets = {}
            self._counts = {}
            _native.pack_row_init(
                self._out_chunk(), self._scratch, self.pack_config,
                self.chunk_records,
            )

    def _advance_full_chunks(self) -> None:
        """Rotate past a filled chunk: the next chunk is initialized, or,
        past the last one, the row completes (as soon as it is full, when
        the chained path would yield the batch)."""
        while self._row is not None and int(self._scratch[0]) == self.chunk_records:
            self._harvest_pairs()
            self._chunk += 1
            if self._chunk >= self.space_shards:
                self._complete_row()
                return
            _native.pack_row_init(
                self._out_chunk(), self._scratch, self.pack_config,
                self.chunk_records,
            )

    def _harvest_pairs(self) -> None:
        """Copy the current chunk's compacted pairs out of the scratch's
        emission region; run once per chunk, before any re-init."""
        if self._compact and int(self._scratch[1]):
            self._row_pairs.append(_native.pack_take_pairs(
                self._scratch, self.pack_config, self.chunk_records
            ))

    def _take_row_pairs(self) -> "tuple[np.ndarray, np.ndarray] | None":
        if not self._compact:
            return None
        pairs, self._row_pairs = self._row_pairs, []
        if not pairs:
            return np.empty(0, dtype=np.uint32), np.empty(0, dtype=np.uint8)
        return (np.concatenate([p[0] for p in pairs]),
                np.concatenate([p[1] for p in pairs]))

    def _complete_row(self) -> None:
        row, self._row = self._row, None
        obs_metrics.FUSED_BATCHES.inc()
        obs_metrics.FUSED_RECORDS.inc(self._count)
        pairs = self._take_row_pairs()
        if self._stage is None:
            staged = None
        elif self._compact:
            staged = self._stage(row, pairs)
        else:
            staged = self._stage(row)
        self._done.append(PackedRow(
            row, staged, self._count, self._next_offsets, self._counts,
            *self._last, pairs=pairs,
        ))

    def _note(self, partition: int, count: int, last_off: "int | None",
              last_ts: int) -> None:
        if last_off is not None and last_off >= 0:
            self._next_offsets[partition] = last_off + 1
            self._last = (partition, last_off, last_ts)
        else:
            self._counts[partition] = self._counts.get(partition, 0) + count
            self._last = (partition, -1, last_ts)

    def append_columns(self, partition: int, key_len, value_len, key_null,
                       value_null, ts, key_hash32, key_hash64, n: int,
                       ts_mode: int = 0, offsets=None) -> int:
        """Append ``n`` records of one partition's columns (``ts`` in the
        unit ``ts_mode`` names: see `io.native.pack_append_columns_native`),
        completing rows as they fill.  Returns ``n``."""
        dense = self._dense_of(partition)
        start = 0
        while start < n:
            self._ensure_row()
            took = _native.pack_append_columns_native(
                self._out_chunk(), self._scratch, self.pack_config,
                self.chunk_records, dense, key_len, value_len, key_null,
                value_null, ts, key_hash32, key_hash64, start, n,
                ts_mode=ts_mode,
            )
            if took == 0:
                raise RuntimeError("fused append made no progress")
            self._count += took
            start += took
            last_ts = int(ts[start - 1])
            if ts_mode == 1:
                last_ts //= 1000
            elif ts_mode == 2:
                last_ts = max(last_ts, 0) // 1000
            self._note(
                partition, took,
                int(offsets[start - 1]) if offsets is not None else None,
                last_ts,
            )
            self._advance_full_chunks()
        return n

    def append_record_set(
        self, data, min_off: int, max_off: int, partition: int,
        verify_crc: bool = False,
        prescan: "tuple[int, int, int] | None" = None,
    ) -> "tuple[int, int, int, int]":
        """Fused decode→pack of a Kafka record set's native-decodable
        prefix (consecutive complete uncompressed v2 frames): the records
        of ``partition`` with ``min_off <= offset < max_off`` go straight
        into rows, completing them as they fill.  Returns ``(accepted,
        consumed_bytes, covered_end, last_offset)``, the contract of the
        chained whole-set decode and its acceptance window.  A malformed
        frame ends the prefix (the caller's per-frame path classifies it);
        a record the row cannot carry raises the packer's ValueError.
        ``prescan`` waives the CRC pass only when it covered the whole
        buffer."""
        buf = np.frombuffer(data, dtype=np.uint8)
        dense = self._dense_of(partition)
        verify = verify_crc and (prescan is None or prescan[1] != len(buf))
        pos = skip = total = 0
        covered = last_all = -1
        while True:
            self._ensure_row()
            appended, pos, cov, last_off, last_ts, full, skip = (
                _native.decode_pack_record_set_native(
                    buf, self._out_chunk(), self._scratch, self.pack_config,
                    self.chunk_records, dense, min_off, max_off, verify,
                    start_pos=pos, skip=skip,
                )
            )
            if appended:
                total += appended
                self._count += appended
                last_all = last_off
                self._note(partition, appended, last_off, last_ts)
            covered = max(covered, cov)
            self._advance_full_chunks()
            if not full:
                return total, pos, covered, last_all

    def append_batch(self, batch: RecordBatch, reason: str) -> int:
        """`append_columns` of a single-partition batch (``ts_s`` seconds),
        its records booked in `fallbacks` under ``reason`` and on
        ``kta_fused_fallback_total`` under its `FALLBACK_LABEL`, never
        silent."""
        n = len(batch)
        if n == 0:
            return 0
        self.fallbacks[reason] = self.fallbacks.get(reason, 0) + n
        obs_metrics.FUSED_FALLBACK.labels(
            reason=FALLBACK_LABEL.get(reason, "frame-fallback")
        ).inc(n)
        p = int(batch.partition[0])
        if not bool((batch.partition == p).all()):
            raise ValueError("fused sink chunks must be single-partition")
        return self.append_columns(
            p, batch.key_len, batch.value_len, batch.key_null,
            batch.value_null, batch.ts_s, batch.key_hash32, batch.key_hash64,
            n, ts_mode=0, offsets=batch.offsets,
        )

    def flush(self) -> None:
        """Complete the partial row at stream end (a row with no records
        is dropped, as the chained path yields no empty batch).  Chunks
        never reached are initialized, i.e. packed empty batches: a short
        sharded row is what `pack_chunks` makes of a short batch."""
        if self._row is None:
            return
        if self._count == 0:
            self._row = None
            self._row_pairs = []
            return
        self._harvest_pairs()  # before the pad inits reset the scratch
        for s in range(self._chunk + 1, self.space_shards):
            _native.pack_row_init(
                self._row[s], self._scratch, self.pack_config,
                self.chunk_records,
            )
        self._complete_row()

    def take_completed(self) -> "list[PackedRow]":
        done, self._done = self._done, []
        return done
