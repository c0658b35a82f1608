"""Wire-v4 per-partition counter update: the hand-written CUDA kernel, its
plain version and its wrapper.

Replaces the reference's Pallas kernel ``_kernel`` behind ``_call`` and
``pallas_counters_update`` (kafka_topic_analyzer_tpu/ops/pallas_counters.py:
52, :111, :148), and computes what the reference's ``counters_update``
(ops/counters.py:27) computes: ``per_partition[p, c] += sum of contrib[r,
c]`` over the valid records r of partition p, exact in int64 and wrapping
modulo 2^64.  The TPU kernel is a one-hot f32 product on the MXU with
12-bit digit splits; the CUDA kernel (``csrc/counters_update.cu``) adds
with exact 64-bit integer atomics into a per-block shared-memory histogram
(or straight into global memory when the ``[P, 7]`` table does not fit a
block), so it needs no digit split and takes any int32 length and batch
size.  The source note gives its bound.

The public signature is the reference's.  The wrapper updates
``per_partition`` in place.  It runs the kernel for CUDA tensors and the
plain version only for CPU tensors — there is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes

import torch

from kafka_topic_analyzer_tpu_torch import _build

#: Record columns of the update: (name, dtype) in argument order.
_COLUMNS = (
    ("partition", torch.int32),
    ("key_len", torch.int32),
    ("value_len", torch.int32),
    ("key_null", torch.bool),
    ("value_null", torch.bool),
    ("valid", torch.bool),
)


def counters_update_plain(
    per_partition: torch.Tensor,  # int64[P, 7]
    partition: torch.Tensor,      # int32[B]
    key_len: torch.Tensor,        # int32[B]
    value_len: torch.Tensor,      # int32[B]
    key_null: torch.Tensor,       # bool[B]
    value_null: torch.Tensor,     # bool[B]
    valid: torch.Tensor,          # bool[B]
    num_partitions: int,
) -> torch.Tensor:
    """The plain PyTorch version: the reference's scatter-add, as an int64
    ``index_add_`` into a ``[P + 1, 7]`` scratch whose last row takes the
    invalid records.  Returns ``per_partition + delta``."""
    kn = valid & ~key_null
    vn = valid & ~value_null
    contrib = torch.stack(
        [
            valid,
            valid & value_null,  # tombstones
            vn,                  # alive
            valid & key_null,    # key_null
            kn,                  # key_non_null
        ],
        dim=1,
    ).to(torch.int64)
    k_bytes = torch.where(kn, key_len, 0).to(torch.int64)
    v_bytes = torch.where(vn, value_len, 0).to(torch.int64)
    contrib = torch.cat([contrib, k_bytes[:, None], v_bytes[:, None]], dim=1)
    idx = torch.where(valid, partition.to(torch.int64), num_partitions)
    scratch = torch.zeros(
        (num_partitions + 1, 7), dtype=torch.int64, device=per_partition.device
    )
    scratch.index_add_(0, idx, contrib)
    return per_partition + scratch[:num_partitions]


#: ``(kta_counters_update, kta_cuda_error_string)``, bound on first launch.
_bound = None


def _bind():
    """Load the kernel's library (building it if missing) and set the C
    signatures, once per process."""
    global _bound
    lib = _build.load("counters_update")
    fn = lib.kta_counters_update
    # Without argtypes ctypes passes each pointer as a 32-bit int.
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.kta_cuda_error_string.argtypes = [ctypes.c_int]
    lib.kta_cuda_error_string.restype = ctypes.c_char_p
    _bound = (fn, lib.kta_cuda_error_string)
    return _bound


def _check(per_partition: torch.Tensor, columns, num_partitions: int) -> None:
    if per_partition.dtype != torch.int64:
        raise TypeError(
            f"counters_update needs an int64 table, got {per_partition.dtype}"
        )
    if tuple(per_partition.shape) != (num_partitions, 7):
        raise ValueError(
            f"counters_update needs a [{num_partitions}, 7] table, got "
            f"{tuple(per_partition.shape)}"
        )
    b = columns[0].shape
    for (name, dtype), col in zip(_COLUMNS, columns):
        if col.dtype != dtype:
            raise TypeError(
                f"counters_update needs {name} as {dtype}, got {col.dtype}"
            )
        if col.dim() != 1 or col.shape != b:
            raise ValueError(
                f"counters_update needs {name} as a [B] vector of the "
                f"partition column's length, got {tuple(col.shape)}"
            )
        if col.device != per_partition.device:
            raise ValueError(
                f"counters_update device mismatch: {name} on {col.device}, "
                f"table on {per_partition.device}"
            )
        if not col.is_contiguous():
            raise ValueError(f"counters_update needs a contiguous {name}")
    if not per_partition.is_contiguous():
        raise ValueError("counters_update needs a contiguous table")


def counters_update(
    per_partition: torch.Tensor,
    partition: torch.Tensor,
    key_len: torch.Tensor,
    value_len: torch.Tensor,
    key_null: torch.Tensor,
    value_null: torch.Tensor,
    valid: torch.Tensor,
    num_partitions: int,
) -> torch.Tensor:
    """Add one batch's records to the ``int64[P, 7]`` counter table, in
    place; returns ``per_partition``.  Columns are ``int32[B]`` partition,
    key and value lengths and ``bool[B]`` key_null, value_null and valid.
    CUDA tensors launch the kernel on the current stream (and add one to
    ``counters_update.launches``); CPU tensors take
    `counters_update_plain`.  Anything else raises."""
    columns = (partition, key_len, value_len, key_null, value_null, valid)
    _check(per_partition, columns, num_partitions)
    device = per_partition.device
    if device.type == "cpu":
        return per_partition.copy_(
            counters_update_plain(per_partition, *columns, num_partitions)
        )
    if device.type != "cuda":
        raise ValueError(f"counters_update runs on cuda or cpu, not {device}")
    if device.index != torch.cuda.current_device():
        raise ValueError(
            f"counters_update launches on the current device "
            f"cuda:{torch.cuda.current_device()}, not {device}"
        )
    launch, error_string = _bound or _bind()
    err = launch(
        per_partition.data_ptr(), *(c.data_ptr() for c in columns),
        partition.shape[0], num_partitions,
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            "counters_update kernel launch failed: " + error_string(err).decode()
        )
    counters_update.launches += 1
    return per_partition


#: Kernel launches since import (or since a caller reset it to 0).
counters_update.launches = 0
