"""Wire-v5 counter-table merge: the hand-written CUDA kernel, its plain
version and its wrapper.

Replaces the reference's Pallas kernel ``_merge_kernel`` behind
``pallas_counters_merge`` (kafka_topic_analyzer_tpu/ops/pallas_counters.py:
216, :224): the exact int64 elementwise ``per_partition + delta`` over the
``[P, 7]`` counter tables.  The TPU kernel works on u32/i32 digit planes
with an explicit carry because TPU Pallas has no i64 lanes; Hopper adds
int64 natively, so the CUDA kernel (``csrc/counters_merge.cu``) is one
grid-stride add.  Given the state's ``overall_size`` / ``overall_count``
scalars, the same launch also adds the step's global sums (the JAX step's
``backends/step.py:227-228``).  Its bound lies below any launch (3 * 56 * P
bytes), so the wrapper keeps its host cost near PyTorch's own dispatch;
the source note gives the numbers.

The wrapper updates ``per_partition`` (and the scalars) in place.  It runs
the kernel for CUDA tensors and the plain version only for CPU tensors —
there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from kafka_topic_analyzer_tpu_torch import _build
from kafka_topic_analyzer_tpu_torch.results import CH

_I64 = torch.int64
#: The delta table's channels (`results.COUNTER_CHANNELS`) that the global
#: sums add: the record count into ``overall_count``, the key and value
#: bytes into ``overall_size``.
_COUNT = CH["total"]
_SIZE = (CH["key_size_sum"], CH["value_size_sum"])
#: The same channels as bit masks, for the kernel.
_COUNT_MASK = 1 << _COUNT
_SIZE_MASK = (1 << _SIZE[0]) | (1 << _SIZE[1])
#: The C entry's argument record (``KtaMergeArgs`` in the source): acc,
#: delta, n, overall_size, overall_count, count_mask, size_mask, stream,
#: device.
_ARGS = struct.Struct("<QQqQQqqQq")
#: ``kta_counters_merge``'s return code for tables off the current device.
_WRONG_DEVICE = -1


def counters_merge_plain(
    per_partition: torch.Tensor,
    delta: torch.Tensor,
    overall_size: "torch.Tensor | None" = None,
    overall_count: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """The plain PyTorch version: returns ``per_partition + delta`` (int64
    wraps modulo 2^64, like the kernel and the TPU digit-carry add).  Given
    the scalars, adds the sum of the key and value byte channels into
    ``overall_size`` and the sum of the record-count channel into
    ``overall_count``, in place."""
    if overall_size is not None:
        overall_size.add_(torch.sum(delta[:, _SIZE[0]] + delta[:, _SIZE[1]]))
        overall_count.add_(torch.sum(delta[:, _COUNT]))
    return per_partition + delta


#: ``(kta_counters_merge, kta_cuda_error_string, raw stream getter)``,
#: bound on first launch.
_bound = None


def _bind():
    """Load the kernel's library (building it if missing) and set the C
    signatures, once per process."""
    global _bound
    lib = _build.load("counters_merge")
    fn = lib.kta_counters_merge
    # One argument: the packed record, passed as a pointer to its bytes
    # (one ctypes conversion instead of one per argument).
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    lib.kta_cuda_error_string.argtypes = [ctypes.c_int]
    lib.kta_cuda_error_string.restype = ctypes.c_char_p
    # The current stream's handle as an int, without building a Stream
    # object (CUDA builds of torch only; reached only for CUDA tensors).
    _bound = (fn, lib.kta_cuda_error_string, torch._C._cuda_getCurrentRawStream)
    return _bound


def _check(per_partition, delta, overall_size, overall_count) -> torch.device:
    """Raise what the kernel does not take; return the tables' device.  It
    runs on every call, so it reads each attribute once."""
    try:
        if per_partition.dtype is not _I64 or delta.dtype is not _I64:
            raise TypeError(
                f"counters_merge needs int64 tables, got {per_partition.dtype} "
                f"and {delta.dtype}"
            )
        shape = per_partition.shape
        if len(shape) != 2 or shape[1] != 7:
            raise ValueError(
                f"counters_merge needs [P, 7] tables, got {tuple(shape)}"
            )
        if delta.shape != shape:
            raise ValueError(
                f"counters_merge shape mismatch: {tuple(shape)} vs "
                f"{tuple(delta.shape)}"
            )
        dev = per_partition.device
        if delta.device != dev:
            raise ValueError(
                f"counters_merge device mismatch: {dev} vs {delta.device}"
            )
        if not (per_partition.is_contiguous() and delta.is_contiguous()):
            raise ValueError("counters_merge needs contiguous tables")
        if not (per_partition.is_cuda or per_partition.is_cpu):
            raise ValueError(f"counters_merge runs on cuda or cpu, not {dev}")
        if overall_size is not None or overall_count is not None:
            if overall_size is None or overall_count is None:
                raise ValueError(
                    "counters_merge takes overall_size and overall_count "
                    "together"
                )
            if not (overall_size.dtype is _I64 and overall_count.dtype is _I64):
                raise TypeError(
                    "counters_merge needs overall_size and overall_count as "
                    f"int64 tensors, got {overall_size.dtype} and "
                    f"{overall_count.dtype}"
                )
            if not (overall_size.dim() == 0 and overall_count.dim() == 0):
                raise ValueError(
                    "counters_merge needs overall_size and overall_count as "
                    f"0-d scalars, got {tuple(overall_size.shape)} and "
                    f"{tuple(overall_count.shape)}"
                )
            if not (overall_size.device == dev and overall_count.device == dev):
                raise ValueError(
                    f"counters_merge device mismatch: tables on {dev}, "
                    f"overall_size on {overall_size.device}, overall_count "
                    f"on {overall_count.device}"
                )
    except AttributeError:  # an argument that is not a tensor
        got = [type(a).__name__
               for a in (per_partition, delta, overall_size, overall_count)
               if a is not None and not isinstance(a, torch.Tensor)]
        raise TypeError(
            f"counters_merge takes tensors, got {', '.join(got)}"
        ) from None
    return dev


def counters_merge(
    per_partition: torch.Tensor,
    delta: torch.Tensor,
    overall_size: "torch.Tensor | None" = None,
    overall_count: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """``per_partition += delta`` for ``int64[P, 7]`` counter tables, in
    place; returns ``per_partition``.  Given ``overall_size`` and
    ``overall_count`` (0-d int64 tensors on the tables' device), also adds
    the global sums of `counters_merge_plain` into them, in the same
    launch.  CUDA tensors launch the kernel on the current stream (and add
    one to ``counters_merge.launches``); CPU tensors take
    `counters_merge_plain`.  Anything else raises."""
    dev = _check(per_partition, delta, overall_size, overall_count)
    if dev.type == "cpu":
        return per_partition.copy_(counters_merge_plain(
            per_partition, delta, overall_size, overall_count
        ))
    launch, error_string, raw_stream = _bound or _bind()
    index = dev.index
    err = launch(_ARGS.pack(
        per_partition.data_ptr(), delta.data_ptr(), 7 * per_partition.shape[0],
        0 if overall_size is None else overall_size.data_ptr(),
        0 if overall_count is None else overall_count.data_ptr(),
        _COUNT_MASK, _SIZE_MASK, raw_stream(index), index,
    ))
    if err != 0:
        if err == _WRONG_DEVICE:
            raise ValueError(
                f"counters_merge launches on the current device "
                f"cuda:{torch.cuda.current_device()}, not {dev}"
            )
        raise RuntimeError(
            "counters_merge kernel launch failed: " + error_string(err).decode()
        )
    counters_merge.launches += 1
    return per_partition


#: Kernel launches since import (or since a caller reset it to 0).
counters_merge.launches = 0
