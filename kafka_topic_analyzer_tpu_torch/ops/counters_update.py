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
size.  Given the state's ``overall_size`` / ``overall_count`` scalars, the
same launch also adds the step's global sums (the JAX step's
``backends/step.py:341-342``).  The source note gives its bound.

The public signature is the reference's, with the two scalars as optional
keywords.  The wrapper updates ``per_partition`` (and the scalars) in
place.  It runs the kernel for CUDA tensors and the plain version only for
CPU tensors — there is no fallback from one to the other.
"""

from __future__ import annotations

import struct

import torch

from kafka_topic_analyzer_tpu_torch import _build
from kafka_topic_analyzer_tpu_torch.ops.counters_merge import check_scalars

_I32, _I64, _BOOL = torch.int32, torch.int64, torch.bool
#: Record columns of the update: (name, dtype) in argument order.
_COLUMNS = (
    ("partition", _I32),
    ("key_len", _I32),
    ("value_len", _I32),
    ("key_null", _BOOL),
    ("value_null", _BOOL),
    ("valid", _BOOL),
)
#: The C entry's argument record (``UpdateArgs`` in the source): the
#: table's and the six columns' pointers, n, num_parts, overall_size,
#: overall_count, stream, device.
_KERNEL = _build.Kernel("counters_update", "kta_counters_update",
                        struct.Struct("<7Qqq3Qq"))


def counters_update_plain(
    per_partition: torch.Tensor,  # int64[P, 7]
    partition: torch.Tensor,      # int32[B]
    key_len: torch.Tensor,        # int32[B]
    value_len: torch.Tensor,      # int32[B]
    key_null: torch.Tensor,       # bool[B]
    value_null: torch.Tensor,     # bool[B]
    valid: torch.Tensor,          # bool[B]
    num_partitions: int,
    overall_size: "torch.Tensor | None" = None,
    overall_count: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """The plain PyTorch version: the reference's scatter-add, as an int64
    ``index_add_`` into a ``[P + 1, 7]`` scratch whose last row takes the
    invalid records.  Returns ``per_partition + delta``.  Given the
    scalars, adds the valid records' key and value bytes into
    ``overall_size`` and their count into ``overall_count``, in place."""
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
    if overall_size is not None:
        overall_size.add_(torch.sum(k_bytes + v_bytes))
        overall_count.add_(torch.sum(contrib[:, 0]))
    contrib = torch.cat([contrib, k_bytes[:, None], v_bytes[:, None]], dim=1)
    idx = torch.where(valid, partition.to(torch.int64), num_partitions)
    scratch = torch.zeros(
        (num_partitions + 1, 7), dtype=torch.int64, device=per_partition.device
    )
    scratch.index_add_(0, idx, contrib)
    return per_partition + scratch[:num_partitions]


def _check(per_partition, columns, num_partitions: int, overall_size,
           overall_count) -> torch.device:
    """Raise what the kernel does not take; return the table's device.  It
    runs on every call, so it tests each property of all the columns in
    one expression and reads each attribute once; a refusal lists what
    each column holds."""
    try:
        if per_partition.dtype is not _I64:
            raise TypeError(
                f"counters_update needs an int64 table, got {per_partition.dtype}"
            )
        if per_partition.shape != (num_partitions, 7):
            raise ValueError(
                f"counters_update needs a [{num_partitions}, 7] table, got "
                f"{tuple(per_partition.shape)}"
            )
        if not per_partition.is_contiguous():
            raise ValueError("counters_update needs a contiguous table")
        dev = per_partition.device
        if not (per_partition.is_cuda or per_partition.is_cpu):
            raise ValueError(f"counters_update runs on cuda or cpu, not {dev}")
        partition, key_len, value_len, key_null, value_null, valid = columns
        if not (partition.dtype is _I32 and key_len.dtype is _I32
                and value_len.dtype is _I32 and key_null.dtype is _BOOL
                and value_null.dtype is _BOOL and valid.dtype is _BOOL):
            raise TypeError(
                "counters_update needs columns of "
                f"{_describe(d for _, d in _COLUMNS)}, got "
                f"{_describe(c.dtype for c in columns)}"
            )
        b = partition.shape
        if not (len(b) == 1 and key_len.shape == b and value_len.shape == b
                and key_null.shape == b and value_null.shape == b
                and valid.shape == b):
            raise ValueError(
                "counters_update needs six [B] vectors of one length, got "
                f"{_describe(tuple(c.shape) for c in columns)}"
            )
        if not (partition.device == dev and key_len.device == dev
                and value_len.device == dev and key_null.device == dev
                and value_null.device == dev and valid.device == dev):
            raise ValueError(
                f"counters_update device mismatch: table on {dev}, columns "
                f"on {_describe(c.device for c in columns)}"
            )
        if not (partition.is_contiguous() and key_len.is_contiguous()
                and value_len.is_contiguous() and key_null.is_contiguous()
                and value_null.is_contiguous() and valid.is_contiguous()):
            raise ValueError(
                "counters_update needs contiguous columns, got contiguous "
                f"{_describe(c.is_contiguous() for c in columns)}"
            )
        if overall_size is not None or overall_count is not None:
            check_scalars("counters_update", "table", dev, overall_size,
                          overall_count)
    except AttributeError:  # an argument that is not a tensor
        got = [type(a).__name__
               for a in (per_partition, *columns, overall_size, overall_count)
               if a is not None and not isinstance(a, torch.Tensor)]
        raise TypeError(
            f"counters_update takes tensors, got {', '.join(got)}"
        ) from None
    return dev


def _describe(values) -> str:
    """``name value`` for each column, for a refusal's message."""
    return ", ".join(f"{name} {v}" for (name, _), v in zip(_COLUMNS, values))


def counters_update(
    per_partition: torch.Tensor,
    partition: torch.Tensor,
    key_len: torch.Tensor,
    value_len: torch.Tensor,
    key_null: torch.Tensor,
    value_null: torch.Tensor,
    valid: torch.Tensor,
    num_partitions: int,
    overall_size: "torch.Tensor | None" = None,
    overall_count: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Add one batch's records to the ``int64[P, 7]`` counter table, in
    place; returns ``per_partition``.  Columns are ``int32[B]`` partition,
    key and value lengths and ``bool[B]`` key_null, value_null and valid.
    Given ``overall_size`` and ``overall_count`` (0-d int64 tensors on the
    table's device), also adds the global sums of `counters_update_plain`
    into them, in the same launch.  CUDA tensors launch the kernel on the
    current stream (and add one to ``counters_update.launches``); CPU
    tensors take `counters_update_plain`.  Anything else raises."""
    dev = _check(per_partition,
                 (partition, key_len, value_len, key_null, value_null, valid),
                 num_partitions, overall_size, overall_count)
    if dev.type == "cpu":
        return per_partition.copy_(counters_update_plain(
            per_partition, partition, key_len, value_len, key_null, value_null,
            valid, num_partitions, overall_size, overall_count,
        ))
    _KERNEL.launch(
        dev, per_partition.data_ptr(), partition.data_ptr(),
        key_len.data_ptr(), value_len.data_ptr(), key_null.data_ptr(),
        value_null.data_ptr(), valid.data_ptr(), partition.shape[0],
        num_partitions,
        0 if overall_size is None else overall_size.data_ptr(),
        0 if overall_count is None else overall_count.data_ptr(),
    )
    counters_update.launches += 1
    return per_partition


#: Kernel launches since import (or since a caller reset it to 0).
counters_update.launches = 0
