"""ctypes bindings to the port's native ingest shim (port of the
reference's ``io/native.py``: the entry points of the synthetic,
segment-file and Kafka wire scans).

The shim is the port's own copy of ``native/ingest.cpp``, built at first
use by `_build.build_native` into ``build/torch_native/``.  It fills
caller-allocated numpy buffers directly; its bytes equal the numpy
generator's and packers' (tests hold them together, pair order aside: the
native dedupe emits pairs in first-touch order, numpy in slot order).

The library is loaded with ``ctypes.CDLL``, which releases the GIL for
every call: the prefetch worker's synthesis and packing overlap the main
thread's dispatches only because of that.  Every bound entry declares its
``argtypes`` and ``restype``; pointers travel as ``c_void_p`` built with
``ndarray.ctypes.data_as``, which keeps the array alive across the call.
A failed build or load is remembered once, with its class
(`native_status`); ``--native off`` (``use_native=False``) or the
reference's ``KTA_DISABLE_NATIVE`` kill switch (read at the first load)
runs without the shim.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, List, Optional

import numpy as np

from kafka_topic_analyzer_tpu_torch import _build
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.records import RecordBatch

#: ABI version the shim reports (``kta_version``).
ABI = 14

#: Environment kill switch: set, the shim is never built or loaded.
_DISABLE_ENV = "KTA_DISABLE_NATIVE"

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_load_error: "Exception | None" = None


class AbiMismatchError(RuntimeError):
    """The built library reports another ABI version than `ABI`."""


class _KtaSynthSpec(ctypes.Structure):
    # Mirrors struct KtaSynthSpec in native/ingest.cpp.
    _fields_ = [
        ("seed", ctypes.c_uint64),
        ("num_partitions", ctypes.c_int32),
        ("messages_per_partition", ctypes.c_int64),
        ("keys_per_partition", ctypes.c_uint64),
        ("key_null_permille", ctypes.c_int32),
        ("tombstone_permille", ctypes.c_int32),
        ("value_len_min", ctypes.c_int32),
        ("value_len_max", ctypes.c_int32),
        ("key_digits", ctypes.c_int32),
        ("ts_start_ms", ctypes.c_int64),
        ("ts_step_ms", ctypes.c_int64),
    ]


_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
#: The fused entry points' shared tail (`_fused_ctail`): batch_size,
#: num_partitions, with_alive, alive_bits, with_hll, hll_p, hll_rows,
#: value_len_cap, wire_v5, q_rows, q_nbuckets, q_edges.
_FUSED_TAIL = [_I64] + [_I32] * 10 + [_P]

#: entry point → (restype, argtypes), for every entry this port binds.
_SIGNATURES = {
    "kta_version": (_I32, []),
    "kta_dedupe_slots": (_I64, [_P, _P, _P, _I64, _I32, _P, _P]),
    "kta_synth_batch": (
        _I32,
        [ctypes.POINTER(_KtaSynthSpec), _P, _I32, _I64, _I64, _I32] + [_P] * 9,
    ),
    "kta_hash_batch": (_I32, [_P, _P, _I64, _I32, _P, _P]),
    "kta_pack_batch": (
        _I64,
        [_P] * 8 + [_I64, _I64] + [_I32] * 10 + [_P, _P, _I64],
    ),
    "kta_pack_scratch_len": (_I64, [_I64, _I32, _I32]),
    "kta_pack_row_init": (_I64, [_P, _I64, _P, _I64] + _FUSED_TAIL),
    "kta_pairs_to_masks": (_I64, [_P, _P, _I64, _I32, _P, _P]),
    "kta_pack_append_columns": (
        _I64,
        [_P, _I64, _P, _I32, _P, _P, _P, _P, _P, _I32, _P, _P, _I64, _I64]
        + _FUSED_TAIL + [_P],
    ),
    "kta_crc32c": (ctypes.c_uint32, [_P, _I64]),
    "kta_snappy_decompress": (_I64, [_P, _I64, _P, _I64]),
    "kta_lz4_decompress": (_I64, [_P, _I64, _P, _I64]),
    "kta_decode_records": (_I64, [_P, _I64, _I32, _I64, _I64] + [_P] * 8),
    "kta_scan_record_set": (_I64, [_P, _I64, _I32, _P, _P]),
    "kta_decode_record_set": (_I64, [_P, _I64, _I32, _I64] + [_P] * 10),
    "kta_decode_pack_record_set": (
        _I64,
        [_P, _I64, _I32, _I64, _I64, _I64, _I32] + _FUSED_TAIL
        + [_P, _I64, _P, _P],
    ),
}


def load_library() -> ctypes.CDLL:
    """The loaded shim, built first if missing; raises on failure.  A
    failure is cached with its reason, so later probes neither rebuild
    nor hide it (`native_status`)."""
    global _lib, _load_error
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise _load_error
        try:
            if os.environ.get(_DISABLE_ENV):
                raise RuntimeError(f"native shim disabled via {_DISABLE_ENV}")
            _build.build_native()
            path = _build.native_library_path()
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            if lib.kta_version() != ABI:
                raise AbiMismatchError(
                    f"native shim ABI mismatch: {path} reports "
                    f"{lib.kta_version()}, expected {ABI}"
                )
        except Exception as e:  # remember the failure
            _load_error = e
            raise
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        load_library()
        return True
    except Exception:
        return False


def native_status() -> "tuple[bool, str]":
    """(available, reason): ``""`` when the shim loaded, else
    ``disabled`` (``KTA_DISABLE_NATIVE``), ``build-failed`` (g++ missing
    or failing), ``abi-mismatch`` or ``load-failed``.  Never re-runs a
    failed build."""
    if native_available():
        return True, ""
    if isinstance(_load_error, RuntimeError) and _DISABLE_ENV in str(_load_error):
        return False, "disabled"
    if isinstance(_load_error, _build.BuildError):
        return False, "build-failed"
    if isinstance(_load_error, AbiMismatchError):
        return False, "abi-mismatch"
    return False, "load-failed"


def _in(arr, dtype) -> ctypes.c_void_p:
    """Pointer to ``arr`` as a contiguous ``dtype`` input (a copy only
    where it is not one already; bool reads as uint8 in place)."""
    a = np.asarray(arr)
    if a.dtype == np.bool_ and np.dtype(dtype) == np.uint8:
        a = a.view(np.uint8)
    return np.ascontiguousarray(a, dtype=dtype).ctypes.data_as(_P)


def _out(arr: np.ndarray, dtype) -> ctypes.c_void_p:
    """Pointer to an output buffer, which must already be contiguous
    ``dtype``: a converted copy would swallow the writes."""
    if arr.dtype != np.dtype(dtype) or not arr.flags.c_contiguous:
        raise ValueError(f"native output buffer must be contiguous {np.dtype(dtype)}")
    if not arr.flags.writeable:
        raise ValueError("native output buffer is read-only")
    return arr.ctypes.data_as(_P)


def _threads(threads: int) -> int:
    return threads if threads > 0 else min(os.cpu_count() or 1, 16)


def synth_batch_native(
    spec: SyntheticSpec, parts: np.ndarray, lo: int, hi: int, threads: int = 0
) -> RecordBatch:
    """Records of global indices ``[lo, hi)`` over the partition list
    ``parts`` (round robin), generated by the shim."""
    lib = load_library()
    n = hi - lo
    parts = np.ascontiguousarray(parts, dtype=np.int32)
    out = {name: np.empty(n, dtype=dt) for name, dt in RecordBatch.FIELDS}
    cspec = _KtaSynthSpec(
        seed=spec.seed,
        num_partitions=spec.num_partitions,
        messages_per_partition=spec.messages_per_partition,
        keys_per_partition=spec.keys_per_partition,
        key_null_permille=spec.key_null_permille,
        tombstone_permille=spec.tombstone_permille,
        value_len_min=spec.value_len_min,
        value_len_max=spec.value_len_max,
        key_digits=spec.key_digits,
        ts_start_ms=spec.ts_start_ms,
        ts_step_ms=spec.ts_step_ms,
    )
    rc = lib.kta_synth_batch(
        ctypes.byref(cspec), parts.ctypes.data_as(_P), len(parts), lo, hi,
        _threads(threads),
        *(_out(out[name].view(np.uint8) if dt == np.bool_ else out[name],
               np.uint8 if dt == np.bool_ else dt)
          for name, dt in RecordBatch.FIELDS),
    )
    if rc != 0:
        raise RuntimeError(f"kta_synth_batch failed with rc={rc}")
    return RecordBatch(**out)


def hash_batch_native(
    data: "bytes | np.ndarray", offsets: np.ndarray, threads: int = 0
) -> "tuple[np.ndarray, np.ndarray]":
    """Hash n packed byte slices ``data[offsets[i]:offsets[i+1]]``: the
    reference-variant fnv32 and the fnv64."""
    lib = load_library()
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(data, bytes) else data
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    h32 = np.empty(n, dtype=np.uint32)
    h64 = np.empty(n, dtype=np.uint64)
    rc = lib.kta_hash_batch(
        _in(buf, np.uint8), offsets.ctypes.data_as(_P), n, _threads(threads),
        _out(h32, np.uint32), _out(h64, np.uint64),
    )
    if rc != 0:
        raise RuntimeError(f"kta_hash_batch failed with rc={rc}")
    return h32, h64


def dedupe_slots_native(
    h32: np.ndarray, active: np.ndarray, alive: np.ndarray, bits: int
) -> "tuple[np.ndarray, np.ndarray]":
    """Last-writer-wins (slot, aliveness) pairs, in first-touch order
    (the numpy version sorts by slot: same set, other order)."""
    lib = load_library()
    n = len(h32)
    slot_out = np.empty(n, dtype=np.uint32)
    alive_out = np.empty(n, dtype=np.uint8)
    count = lib.kta_dedupe_slots(
        _in(h32, np.uint32), _in(active, np.uint8), _in(alive, np.uint8), n,
        bits, _out(slot_out, np.uint32), _out(alive_out, np.uint8),
    )
    if count < 0:
        raise RuntimeError(f"kta_dedupe_slots failed with rc={count}")
    return slot_out[:count], alive_out[:count]


def pairs_to_masks_native(
    slots: np.ndarray, flags: np.ndarray, bits: int,
    set_out: np.ndarray, clear_out: np.ndarray,
) -> int:
    """Apply a raw (slot, flag) pair stream, in stream order with
    duplicates, last-writer-wins into set/clear word masks (zeroed here).
    Returns the number of distinct slots touched."""
    lib = load_library()
    touched = lib.kta_pairs_to_masks(
        _in(slots, np.uint32), _in(flags, np.uint8), len(slots), bits,
        _out(set_out, np.uint32), _out(clear_out, np.uint32),
    )
    if touched < 0:
        raise RuntimeError(f"kta_pairs_to_masks failed rc={touched}")
    return int(touched)


def _bytes_in(buf) -> "tuple[np.ndarray, ctypes.c_void_p]":
    """A read-only uint8 view of any bytes-like ``buf`` (bytes, bytearray,
    memoryview, uint8 array) and its pointer, without a copy."""
    data = buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, dtype=np.uint8)
    return data, _in(data, np.uint8)


def crc32c_native(data) -> int:
    """CRC32-C (Castagnoli) of a bytes-like buffer (Kafka's record-batch
    checksum)."""
    arr, ptr = _bytes_in(data)
    return int(load_library().kta_crc32c(ptr, len(arr)))


def decompress_native(fn_name: str, data, cap: int) -> "bytes | None":
    """``kta_snappy_decompress`` or ``kta_lz4_decompress`` of ``data`` into
    at most ``cap`` bytes; None on malformed input or a short ``cap`` (the
    Python decoders then give the verdict)."""
    fn = getattr(load_library(), fn_name)
    src, ptr = _bytes_in(data)
    out = np.empty(cap, dtype=np.uint8)
    n = fn(ptr, len(src), _out(out, np.uint8), cap)
    return out[:n].tobytes() if n >= 0 else None


#: The record decoder's column layout, in the shim's argument order: one
#: spec for every allocation (per frame, per record set, marker-only).
_SOA_COLUMNS = (
    ("offsets", np.int64),
    ("ts_ms", np.int64),
    ("key_len", np.int32),
    ("value_len", np.int32),
    ("key_null", np.uint8),
    ("value_null", np.uint8),
    ("key_hash32", np.uint32),
    ("key_hash64", np.uint64),
)


def _soa_columns(n: int) -> "dict[str, np.ndarray]":
    return {k: np.empty(n, dtype=d) for k, d in _SOA_COLUMNS}


def _soa_ptrs(out: "dict[str, np.ndarray]") -> list:
    return [_out(out[k], d) for k, d in _SOA_COLUMNS]


def decode_records_native(frame) -> "dict[str, np.ndarray] | None":
    """One RecordBatch v2 frame (`kafka_codec.BatchFrame`) decoded into
    columns with the key hashes computed inline.  None for a legacy
    message set or malformed input, so the caller's Python decoder gives
    the precise error."""
    if getattr(frame, "legacy_records", None) is not None:
        return None
    n = frame.num_records
    # num_records is an untrusted wire field: a record needs >= 7 payload
    # bytes, so a larger count is malformed; reject it before sizing eight
    # arrays by it.
    if n > max(len(frame.payload) // 7, 0):
        return None
    payload, ptr = _bytes_in(frame.payload)
    out = _soa_columns(n)
    rc = load_library().kta_decode_records(
        ptr, len(payload), n, frame.base_offset, frame.first_ts, *_soa_ptrs(out)
    )
    return out if rc == n else None


def scan_record_set_native(buf, verify_crc: bool = False) -> "tuple[int, int, int]":
    """Header walk of a record set's native-decodable prefix (consecutive
    complete uncompressed v2 frames): ``(records, consumed_bytes,
    covered_end)``, without touching the records."""
    data, ptr = _bytes_in(buf)
    st = np.zeros(2, dtype=np.int64)
    st[1] = -1
    n = load_library().kta_scan_record_set(
        ptr, len(data), 1 if verify_crc else 0,
        _out(st[0:1], np.int64), _out(st[1:2], np.int64),
    )
    if n < 0:
        return 0, 0, -1
    return int(n), int(st[0]), int(st[1])


def decode_record_set_native(
    buf, verify_crc: bool = False, prescan: "tuple[int, int, int] | None" = None,
) -> "tuple[dict[str, np.ndarray], int, int]":
    """The native-decodable prefix of a record set decoded in one call:
    ``(columns, consumed_bytes, covered_end)``, where ``covered_end`` is
    the largest ``base_offset + last_offset_delta + 1`` of the decoded
    frames (-1 none).  A malformed frame inside the prefix gives
    ``consumed = 0``, so the per-frame path can classify it.
    ``prescan``: a `scan_record_set_native` result for this buffer (its
    CRC pass already done)."""
    lib = load_library()
    data, ptr = _bytes_in(buf)
    if prescan is not None:
        n, consumed, covered = prescan
        verify_crc = False  # the prescan checksummed the prefix
    else:
        n, consumed, covered = scan_record_set_native(data, verify_crc)
    if n == 0:
        # No messages, but the prefix may still cover offsets (control
        # markers only): the caller advances past it.
        return _soa_columns(0), consumed, covered
    out = _soa_columns(n)
    st = np.zeros(2, dtype=np.int64)
    st[1] = -1
    rc = lib.kta_decode_record_set(
        ptr, len(data), 1 if verify_crc else 0, n, *_soa_ptrs(out),
        _out(st[0:1], np.int64), _out(st[1:2], np.int64),
    )
    if rc != n:
        return {}, 0, -1
    return out, int(st[0]), int(st[1])


def _pallas_value_cap(config) -> int:
    """The 16 MiB - 1 value cap of ``--pallas`` under wire v4 (0 = none)."""
    from kafka_topic_analyzer_tpu_torch.packing import MAX_VALUE_LEN

    return (
        MAX_VALUE_LEN
        if config.use_pallas_counters and config.wire_format == 4
        else 0
    )


def _quant_section(config) -> "tuple[int, int, np.ndarray | None]":
    """(q_rows, q_nbuckets, edges) of the wire-v5 DDSketch section, or
    (0, 0, None) when the row has none.  The edges are the cached
    ``ddsketch_edges`` array, alive for the process."""
    if config.wire_format != 5 or not config.enable_quantiles:
        return 0, 0, None
    from kafka_topic_analyzer_tpu_torch.ops.ddsketch import ddsketch_edges

    q_rows = config.num_partitions if config.quantiles_per_partition else 1
    return (
        q_rows,
        config.quantile_buckets,
        ddsketch_edges(config.quantile_gamma, config.quantile_buckets),
    )


def _edges_ptr(edges: "np.ndarray | None"):
    return None if edges is None else _in(edges, np.int64)


def pack_batch_native(
    batch: RecordBatch, config, out: "np.ndarray | None" = None
) -> "np.ndarray | None":
    """One row in the config's wire format, packed in C++.  Returns None
    when the shim rejects the batch (a value out of range), so the numpy
    packer can raise its descriptive error; a rejected batch may leave
    partial bytes in ``out``."""
    from kafka_topic_analyzer_tpu_torch.packing import (
        hll_table_rows,
        hll_wire_mode,
        packed_nbytes,
    )

    lib = load_library()
    b = config.batch_size
    n = len(batch)
    if n > b:
        raise ValueError(f"batch of {n} exceeds batch_size {b}")
    nbytes = packed_nbytes(config, b)
    if out is None:
        out = np.empty(nbytes, dtype=np.uint8)
    elif out.shape != (nbytes,):
        raise ValueError("pack_batch_native out= must be contiguous uint8[packed_nbytes]")
    q_rows, q_nb, edges = _quant_section(config)
    got = lib.kta_pack_batch(
        _in(batch.partition, np.int32),
        _in(batch.key_len, np.int32),
        _in(batch.value_len, np.int32),
        _in(batch.key_null, np.uint8),
        _in(batch.value_null, np.uint8),
        _in(batch.ts_s, np.int64),
        _in(batch.key_hash32, np.uint32),
        _in(batch.key_hash64, np.uint64),
        batch.num_valid,
        b,
        config.num_partitions,
        # Under compaction the row carries no pair sections (the caller
        # dedupes the batch separately, packing.batch_alive_pairs).
        1 if config.count_alive_keys and not config.compact_alive else 0,
        config.alive_bitmap_bits,
        hll_wire_mode(config, b),
        config.hll_p,
        hll_table_rows(config, b),
        _pallas_value_cap(config),
        1 if config.wire_format == 5 else 0,
        q_rows,
        q_nb,
        _edges_ptr(edges),
        _out(out, np.uint8),
        out.nbytes,
    )
    if got < 0:
        return None
    if got != out.nbytes:
        raise RuntimeError(f"kta_pack_batch wrote {got} of {out.nbytes} bytes")
    return out


# ---------------------------------------------------------------------------
# incremental packing into one row (packing.FusedPackSink)


def _with_alive_mode(config) -> int:
    """0 = no alive pairs, 1 = per-row pair sections, 2 = compacted (the
    pairs divert to the scratch's emission region)."""
    if not config.count_alive_keys:
        return 0
    return 2 if config.compact_alive else 1


def _fused_pack_params(config, batch_size: int) -> tuple:
    """The row parameters the incremental entry points share, derived by
    the same packing rules as `pack_batch_native`, so an appended row's
    layout cannot drift from a packed batch's."""
    from kafka_topic_analyzer_tpu_torch.packing import hll_table_rows, hll_wire_mode

    q_rows, q_nb, edges = _quant_section(config)
    return (
        batch_size,
        config.num_partitions,
        _with_alive_mode(config),
        config.alive_bitmap_bits,
        hll_wire_mode(config, batch_size),
        config.hll_p,
        hll_table_rows(config, batch_size),
        _pallas_value_cap(config),
        1 if config.wire_format == 5 else 0,
        q_rows,
        q_nb,
        edges,
    )


def _fused_ctail(params) -> list:
    return [*params[:-1], _edges_ptr(params[-1])]


def _raise_pack_range(field: int, value: int) -> None:
    """The pack-range error of an append, as the numpy packer words it."""
    from kafka_topic_analyzer_tpu_torch.packing import MAX_KEY_LEN, MAX_VALUE_LEN

    if value < 0:
        raise ValueError("negative key/value length in record batch")
    if field == 0:
        raise ValueError(
            f"key length {int(value)} exceeds the packed "
            f"transfer limit of {MAX_KEY_LEN} bytes"
        )
    raise ValueError(
        f"value length {int(value)} exceeds the Pallas "
        f"counter kernel's limit of {MAX_VALUE_LEN} bytes — disable "
        f"use_pallas_counters for such topics"
    )


def pack_scratch_len(config, batch_size: int) -> int:
    """int64 elements of scratch one appended row needs (with the
    compacted pairs' emission region under compaction)."""
    n = load_library().kta_pack_scratch_len(
        batch_size, _with_alive_mode(config), config.alive_bitmap_bits
    )
    if n < 0:
        raise RuntimeError("kta_pack_scratch_len rejected batch_size")
    return int(n)


def pack_take_pairs(
    scratch: np.ndarray, config, batch_size: int
) -> "tuple[np.ndarray, np.ndarray]":
    """Copies of the current row's compacted (slot, alive) pairs from the
    scratch's emission region, which starts at the alive-mode-1 scratch
    length.  Harvest before the next `pack_row_init` resets it."""
    n = int(scratch[1])
    off = int(load_library().kta_pack_scratch_len(
        batch_size, 1, config.alive_bitmap_bits
    ))
    region = scratch[off:].view(np.uint8)
    slots = region[: 4 * batch_size].view(np.uint32)[:n].copy()
    flags = region[4 * batch_size : 5 * batch_size][:n].copy()
    return slots, flags


def pack_row_init(out: np.ndarray, scratch: np.ndarray, config,
                  batch_size: int) -> None:
    """Initialize a row for appends: the result equals a packed empty
    batch."""
    need = load_library().kta_pack_row_init(
        _out(out, np.uint8), out.nbytes, _out(scratch, np.int64), len(scratch),
        *_fused_ctail(_fused_pack_params(config, batch_size)),
    )
    if need != out.nbytes:
        raise RuntimeError(
            f"kta_pack_row_init layout mismatch: need={need}, buffer={out.nbytes}"
        )


def decode_pack_record_set_native(
    data: np.ndarray,
    out: np.ndarray,
    scratch: np.ndarray,
    config,
    batch_size: int,
    dense_partition: int,
    min_off: int,
    max_off: int,
    verify_crc: bool = False,
    start_pos: int = 0,
    skip: int = 0,
) -> "tuple[int, int, int, int, int, bool, int]":
    """Fused decode→pack of a record set's native-decodable prefix into a
    row: the records of ``[min_off, max_off)`` are appended until the row
    is full.  Returns ``(appended, consumed, covered_end, last_off,
    last_ts_s, row_full, resume_skip)``; on ``row_full`` the caller starts
    a new row and calls again with ``start_pos=consumed,
    skip=resume_skip``.  A malformed frame ends the walk at its start (the
    per-frame path classifies it); a record the row cannot carry raises
    the numpy packer's ValueError."""
    st = np.zeros(8, dtype=np.int64)
    st[4] = skip
    rc = load_library().kta_decode_pack_record_set(
        _in(data, np.uint8), len(data), 1 if verify_crc else 0, start_pos,
        min_off, max_off, dense_partition,
        *_fused_ctail(_fused_pack_params(config, batch_size)),
        _out(out, np.uint8), out.nbytes, _out(scratch, np.int64),
        _out(st, np.int64),
    )
    if rc == -2:
        _raise_pack_range(int(st[6]), int(st[7]))
    if rc < 0:
        raise RuntimeError(f"kta_decode_pack_record_set failed rc={rc}")
    return (
        int(rc), int(st[0]), int(st[1]), int(st[2]), int(st[3]),
        bool(st[5]), int(st[4]),
    )


def pack_append_columns_native(
    out: np.ndarray,
    scratch: np.ndarray,
    config,
    batch_size: int,
    dense_partition: int,
    key_len, value_len, key_null, value_null, ts, key_hash32, key_hash64,
    start: int,
    n: int,
    ts_mode: int = 0,
) -> int:
    """Append records ``[start, n)`` (``n`` is the exclusive end index)
    of one partition's columns to a row, up to its capacity; returns the
    count appended.  ``ts_mode``: 0 = ``ts`` is seconds, 1 = milliseconds
    floor-divided by 1000 (the segment reader's rule), 2 = milliseconds
    clamped at 0, then divided."""
    detail = np.zeros(2, dtype=np.int64)
    rc = load_library().kta_pack_append_columns(
        _out(out, np.uint8), out.nbytes, _out(scratch, np.int64),
        dense_partition,
        _in(key_len, np.int32),
        _in(value_len, np.int32),
        _in(key_null, np.uint8),
        _in(value_null, np.uint8),
        _in(ts, np.int64),
        ts_mode,
        _in(key_hash32, np.uint32),
        _in(key_hash64, np.uint64),
        start,
        n,
        *_fused_ctail(_fused_pack_params(config, batch_size)),
        _out(detail, np.int64),
    )
    if rc == -2:
        _raise_pack_range(int(detail[0]), int(detail[1]))
    if rc < 0:
        raise RuntimeError(f"kta_pack_append_columns failed rc={rc}")
    return int(rc)


class NativeSyntheticSource(SyntheticSource):
    """`SyntheticSource` with the records generated by the shim: the same
    stream, on ``threads`` threads (0 = up to 16)."""

    def __init__(self, spec: SyntheticSpec, threads: int = 0):
        super().__init__(spec)
        self.threads = threads
        load_library()  # fail here if the shim cannot be built

    def batches(
        self,
        batch_size: int,
        partitions: Optional[List[int]] = None,
        start_at: "Optional[dict[int, int]]" = None,
    ) -> Iterator[RecordBatch]:
        parts = np.array(
            sorted(partitions) if partitions is not None else self.partitions(),
            dtype=np.int32,
        )
        if len(parts) == 0:
            return
        n = self.spec.messages_per_partition
        if start_at:
            # Partition-sequential resume: with one partition the global
            # index is the offset.
            for p in parts.tolist():
                one = np.array([p], dtype=np.int32)
                for lo in range(min(start_at.get(p, 0), n), n, batch_size):
                    yield synth_batch_native(
                        self.spec, one, lo, min(lo + batch_size, n), self.threads
                    )
            return
        total = n * len(parts)
        for lo in range(0, total, batch_size):
            yield synth_batch_native(
                self.spec, parts, lo, min(lo + batch_size, total), self.threads
            )
