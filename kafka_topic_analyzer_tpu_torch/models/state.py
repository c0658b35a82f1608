"""Analyzer state as dataclasses of tensors (port of the reference's
``models/*.py``).

Same leaves, shapes and dtypes as the reference's ``AnalyzerState``, with
one exception: alive-bitmap words are ``int32`` bit patterns instead of
``uint32`` (`_torch_support`).  Optional sub-states are ``None`` when
their feature is off.  Every leaf is its own tensor on an explicit
device; the step updates them in place.

`state_to_numpy` / `state_from_numpy` carry a state across the framework
boundary as a dict of numpy arrays keyed by leaf path
(``"metrics.per_partition"``, ``"alive.words"``, ...), with alive words as
``uint32`` — the reference's leaves, so a scan can start in one package
and finish in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from kafka_topic_analyzer_tpu_torch._torch_support import (
    i32_to_u32,
    resolve_device,
    u32_to_i32,
)
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.ops.bitmap import bitmap_num_words
from kafka_topic_analyzer_tpu_torch.ops.counters import I64_MAX, I64_MIN
from kafka_topic_analyzer_tpu_torch.ops.ddsketch import ddsketch_num_buckets


@dataclasses.dataclass
class MessageMetricsState:
    """Exact counters: one ``int64[P, 7]`` matrix (channel order
    ``results.COUNTER_CHANNELS``), per-partition extremes and two global
    int64 scalars."""

    per_partition: torch.Tensor  # int64[P, 7]
    earliest_s: torch.Tensor     # int64[P], I64_MAX until first record
    latest_s: torch.Tensor       # int64[P], I64_MIN until first record
    smallest: torch.Tensor       # int64[P], I64_MAX until first sized record
    largest: torch.Tensor        # int64[P]
    overall_size: torch.Tensor   # int64 scalar
    overall_count: torch.Tensor  # int64 scalar

    @classmethod
    def init(cls, config: AnalyzerConfig, device) -> "MessageMetricsState":
        p = config.num_partitions

        def full(value, shape=(p,)):
            return torch.full(shape, value, dtype=torch.int64, device=device)

        return cls(
            per_partition=full(0, (p, 7)),
            earliest_s=full(I64_MAX),
            latest_s=full(I64_MIN),
            smallest=full(I64_MAX),
            largest=full(0),
            overall_size=full(0, ()),
            overall_count=full(0, ()),
        )


@dataclasses.dataclass
class AliveBitmapState:
    words: torch.Tensor  # int32[W] packed bits (u32 bit patterns)

    @classmethod
    def init(cls, config: AnalyzerConfig, device) -> "AliveBitmapState":
        w = bitmap_num_words(config.alive_bitmap_bits)
        return cls(words=torch.zeros((w,), dtype=torch.int32, device=device))


@dataclasses.dataclass
class HLLState:
    regs: torch.Tensor  # int32[R, 2^p]; R = P or 1

    @classmethod
    def init(cls, config: AnalyzerConfig, device) -> "HLLState":
        rows = config.num_partitions if config.distinct_keys_per_partition else 1
        return cls(
            regs=torch.zeros((rows, config.hll_m), dtype=torch.int32, device=device)
        )


@dataclasses.dataclass
class DDSketchState:
    counts: torch.Tensor  # int64[R, nbuckets + 2]; R = P or 1

    @classmethod
    def init(cls, config: AnalyzerConfig, device) -> "DDSketchState":
        n = ddsketch_num_buckets(config.quantile_buckets)
        rows = config.num_partitions if config.quantiles_per_partition else 1
        return cls(counts=torch.zeros((rows, n), dtype=torch.int64, device=device))


@dataclasses.dataclass
class AnalyzerState:
    metrics: MessageMetricsState
    alive: Optional[AliveBitmapState]
    hll: Optional[HLLState]
    quantiles: Optional[DDSketchState]

    @classmethod
    def init(cls, config: AnalyzerConfig, device) -> "AnalyzerState":
        return cls(
            metrics=MessageMetricsState.init(config, device),
            alive=(
                AliveBitmapState.init(config, device)
                if config.count_alive_keys else None
            ),
            hll=HLLState.init(config, device) if config.enable_hll else None,
            quantiles=(
                DDSketchState.init(config, device)
                if config.enable_quantiles else None
            ),
        )


_METRIC_LEAVES = tuple(f.name for f in dataclasses.fields(MessageMetricsState))


def state_to_numpy(state: AnalyzerState) -> Dict[str, np.ndarray]:
    """Leaf path → host numpy array (a copy), the reference's dtypes
    (alive words as ``uint32``)."""
    def host(t: torch.Tensor) -> np.ndarray:
        return t.to("cpu", copy=True).numpy()

    out = {
        f"metrics.{name}": host(getattr(state.metrics, name))
        for name in _METRIC_LEAVES
    }
    if state.alive is not None:
        out["alive.words"] = i32_to_u32(host(state.alive.words))
    if state.hll is not None:
        out["hll.regs"] = host(state.hll.regs)
    if state.quantiles is not None:
        out["quantiles.counts"] = host(state.quantiles.counts)
    return out


def state_from_numpy(
    leaves: Dict[str, np.ndarray], device=None
) -> AnalyzerState:
    """Inverse of `state_to_numpy`: the sub-states present in ``leaves``
    are built on ``device`` (each leaf copied into a tensor of its own).
    The device is CUDA unless the caller asks for the CPU; a missing CUDA
    device raises (`resolve_device`)."""
    device = resolve_device(device)

    def tensor(arr, dtype):
        return torch.from_numpy(np.array(arr, dtype=dtype)).to(device)

    metrics = MessageMetricsState(
        **{
            name: tensor(leaves[f"metrics.{name}"], np.int64)
            for name in _METRIC_LEAVES
        }
    )
    alive = hll = quantiles = None
    if "alive.words" in leaves:
        alive = AliveBitmapState(words=tensor(u32_to_i32(leaves["alive.words"]), np.int32))
    if "hll.regs" in leaves:
        hll = HLLState(regs=tensor(leaves["hll.regs"], np.int32))
    if "quantiles.counts" in leaves:
        quantiles = DDSketchState(counts=tensor(leaves["quantiles.counts"], np.int64))
    return AnalyzerState(metrics=metrics, alive=alive, hll=hll, quantiles=quantiles)
