"""Packed host→device batch transfer, wire formats v4 and v5 (port of
the reference's ``packing.py``, its numpy path).

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
packers for the same config (tests hold them together).  Device-side
unpacking is ``Tensor.view(dtype)`` over byte slices; a section whose
offset is not a multiple of its item size (possible after a 1, 2 or 5
B/record section at an odd batch size) is copied first, since ``view``
needs an aligned offset.  u32/u16 sections come out as int32/int16 bit
patterns (`_torch_support`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
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


def pair_table_capacity(config: AnalyzerConfig, batch_size: int) -> int:
    """Capacity of one dispatch's pair table: a dispatch folds at most
    ``batch_size`` records and distinct slots cannot exceed the slot space,
    so ``min(B, 2^bits)`` bounds the merge with no overflow path."""
    return min(int(batch_size), 1 << config.alive_bitmap_bits)


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
    batch: RecordBatch, config: AnalyzerConfig
) -> Tuple[np.ndarray, np.ndarray]:
    """One batch's LWW-deduped (slot, alive) pairs."""
    active = batch.valid & ~batch.key_null
    alive = batch.valid & ~batch.value_null
    return dedupe_slots_numpy(
        batch.key_hash32, active, alive, config.alive_bitmap_bits
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
    out: "np.ndarray | None" = None,
) -> "tuple[np.ndarray, int, int]":
    """LWW-merge per-batch pair lists, in stream order, into one packed
    pair-table buffer (header + the ``pair_table`` sections of
    `_sections`).  Returns ``(buffer, raw_pairs, emitted_pairs)``."""
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
    if raw:
        merged_slots, merged_flags = dedupe_slots_numpy(
            slots, np.ones(raw, dtype=bool), flags, config.alive_bitmap_bits
        )
    else:
        merged_slots, merged_flags = slots, flags
    n = len(merged_slots)
    if alive_table_mode(config, capacity) == 2:
        set_w, clear_w = _pairs_to_masks_numpy(
            merged_slots, merged_flags, config.alive_bitmap_bits
        )
        secs["alive_set"][:] = set_w
        secs["alive_clear"][:] = clear_w
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
    out: "np.ndarray | None" = None,
) -> np.ndarray:
    """RecordBatch → one contiguous ``uint8`` row in the config's wire
    format (the module docstring is the layout).  Valid records must be a prefix of the
    batch.  ``out`` packs into a caller-provided ``uint8[packed_nbytes]``
    buffer (a pinned staging row); every byte of it is overwritten."""
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
