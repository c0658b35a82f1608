"""Wire-v5 counter-table merge: the hand-written CUDA kernel, its plain
version and its wrapper.

Replaces the reference's Pallas kernel ``_merge_kernel`` behind
``pallas_counters_merge`` (kafka_topic_analyzer_tpu/ops/pallas_counters.py:
216, :224): the exact int64 elementwise ``per_partition + delta`` over the
``[P, 7]`` counter tables.  The TPU kernel works on u32/i32 digit planes
with an explicit carry because TPU Pallas has no i64 lanes; Hopper adds
int64 natively, so the CUDA kernel (``csrc/counters_merge.cu``) is one
grid-stride add.  It is launch-latency-bound (3 * 56 * P bytes); the
source note gives the numbers.

The wrapper updates ``per_partition`` in place.  It runs the kernel for
CUDA tensors and the plain version only for CPU tensors — there is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from kafka_topic_analyzer_tpu_torch import _build


def counters_merge_plain(
    per_partition: torch.Tensor, delta: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version: ``per_partition + delta`` (int64 wraps
    modulo 2^64, like the kernel and the TPU digit-carry add)."""
    return per_partition + delta


#: ``(kta_counters_merge, kta_cuda_error_string)``, bound on first launch.
_bound = None


def _bind():
    """Load the kernel's library (building it if missing) and set the C
    signatures, once per process."""
    global _bound
    lib = _build.load("counters_merge")
    fn = lib.kta_counters_merge
    # Without argtypes ctypes passes each pointer as a 32-bit int.
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.kta_cuda_error_string.argtypes = [ctypes.c_int]
    lib.kta_cuda_error_string.restype = ctypes.c_char_p
    _bound = (fn, lib.kta_cuda_error_string)
    return _bound


def counters_merge(
    per_partition: torch.Tensor, delta: torch.Tensor
) -> torch.Tensor:
    """``per_partition += delta`` for ``int64[P, 7]`` counter tables, in
    place; returns ``per_partition``.  CUDA tensors launch the kernel on
    the current stream (and add one to ``counters_merge.launches``); CPU
    tensors take `counters_merge_plain`.  Anything else raises."""
    if per_partition.dtype != torch.int64 or delta.dtype != torch.int64:
        raise TypeError(
            f"counters_merge needs int64 tables, got {per_partition.dtype} "
            f"and {delta.dtype}"
        )
    if per_partition.dim() != 2 or per_partition.shape[1] != 7:
        raise ValueError(
            f"counters_merge needs [P, 7] tables, got {tuple(per_partition.shape)}"
        )
    if delta.shape != per_partition.shape:
        raise ValueError(
            f"counters_merge shape mismatch: {tuple(per_partition.shape)} vs "
            f"{tuple(delta.shape)}"
        )
    if per_partition.device != delta.device:
        raise ValueError(
            f"counters_merge device mismatch: {per_partition.device} vs "
            f"{delta.device}"
        )
    if not (per_partition.is_contiguous() and delta.is_contiguous()):
        raise ValueError("counters_merge needs contiguous tables")
    if per_partition.device.type == "cpu":
        return per_partition.copy_(counters_merge_plain(per_partition, delta))
    if per_partition.device.type != "cuda":
        raise ValueError(
            f"counters_merge runs on cuda or cpu, not {per_partition.device}"
        )
    if per_partition.device.index != torch.cuda.current_device():
        raise ValueError(
            f"counters_merge launches on the current device "
            f"cuda:{torch.cuda.current_device()}, not {per_partition.device}"
        )
    launch, error_string = _bound or _bind()
    err = launch(
        per_partition.data_ptr(), delta.data_ptr(), per_partition.numel(),
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            "counters_merge kernel launch failed: " + error_string(err).decode()
        )
    counters_merge.launches += 1
    return per_partition


#: Kernel launches since import (or since a caller reset it to 0).
counters_merge.launches = 0
