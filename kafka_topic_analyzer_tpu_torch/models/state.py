"""Analyzer state as dataclasses of tensors (port of the reference's
``models/*.py``).

Same leaves, shapes and dtypes as the reference's ``AnalyzerState``, with
two exceptions: alive-bitmap words are ``int32`` bit patterns instead of
``uint32`` (`_torch_support`), and the single-device backend may hold the
alive keys as an exact set of the slots seen (`AliveSetState`,
``ops/alive_set.py``) instead of the dense bitmap (`AliveBitmapState`);
its leaf is the bitmap's words all the same.  The two alive forms offer
one surface (``apply_pairs``, ``host_words``, ``count``), so the step,
snapshots and finalize read either without asking which it is; the
backend that holds a set sizes it (``backends/alive.py``).  Optional
sub-states are ``None`` when their feature is off.  Every leaf is its own tensor on an
explicit device; the step updates them in place.

`state_to_numpy` / `state_from_numpy` carry a state across the framework
boundary as a dict of numpy arrays keyed by leaf path
(``"metrics.per_partition"``, ``"alive.words"``, ...), with alive words as
``uint32`` — the reference's leaves, so a scan can start in one package
and finish in the other; `copy_from_numpy_` loads such a dict into an
existing state (a snapshot resume, `checkpoint.py`).  `merge_rows`
folds a mesh state's stacked leaves into that layout (`MERGE_LAW`).
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
from kafka_topic_analyzer_tpu_torch.ops.alive_set import (
    EMPTY,
    META_WORDS,
    alive_set_apply,
    alive_set_count,
    alive_set_words,
)
from kafka_topic_analyzer_tpu_torch.ops.bitmap import bitmap_apply_pairs, bitmap_num_words
from kafka_topic_analyzer_tpu_torch.ops.counters import I64_MAX, I64_MIN
from kafka_topic_analyzer_tpu_torch.ops.ddsketch import ddsketch_num_buckets


def _host(t: torch.Tensor) -> np.ndarray:
    return t.to("cpu", copy=True).numpy()


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

    def apply_pairs(self, slot, alive_flag, n_pairs, config: AnalyzerConfig,
                    space_index: int = 0) -> None:
        """Apply a pair list to space shard ``space_index``'s words
        (`ops.bitmap.bitmap_apply_pairs`)."""
        bitmap_apply_pairs(self.words, slot, alive_flag, n_pairs,
                           bits=config.alive_bitmap_bits, space_index=space_index,
                           space_shards=config.space_shards)

    def host_words(self) -> np.ndarray:
        """The words on the host, as ``uint32`` (a copy)."""
        return i32_to_u32(_host(self.words))

    def count(self) -> int:
        """The alive count: the words' popcount, on the host."""
        return int(np.bitwise_count(self.host_words()).sum())


@dataclasses.dataclass
class AliveSetState:
    """The alive keys as an exact set of the slots seen (layout in
    ``ops/alive_set.py``): the same answer as a ``2^bits``-slot bitmap."""

    keys: torch.Tensor   # int32[C] slot bit patterns, EMPTY (-1) free
    alive: torch.Tensor  # int32[C / 32] an entry's aliveness bit
    meta: torch.Tensor   # int32[4] entries, slot 0xFFFFFFFF's bit, full, spare
    bits: int            # the bitmap's slots are 2^bits

    @classmethod
    def empty(cls, capacity: int, bits: int, device) -> "AliveSetState":
        return cls(
            keys=torch.full((capacity,), EMPTY - (1 << 32), dtype=torch.int32,
                            device=device),
            alive=torch.zeros((capacity // 32,), dtype=torch.int32, device=device),
            meta=torch.zeros((META_WORDS,), dtype=torch.int32, device=device),
            bits=bits,
        )

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def apply_pairs(self, slot, alive_flag, n_pairs, config: AnalyzerConfig,
                    space_index: int = 0) -> None:
        """Apply a pair list (`ops.alive_set.alive_set_apply`); the set
        stands in for a whole, unsharded bitmap."""
        if config.space_shards != 1:
            raise ValueError("an exact alive set holds an unsharded bitmap")
        alive_set_apply(self.keys, self.alive, self.meta, slot, alive_flag,
                        n_pairs, self.bits)

    def host_words(self) -> np.ndarray:
        """The dense bitmap's ``uint32`` words, built on the host from the
        set's entries (`ops.alive_set.alive_set_words`)."""
        return alive_set_words(_host(self.keys), _host(self.alive),
                               _host(self.meta), self.bits)

    def count(self) -> int:
        """The alive count, counted on the device (24 bytes cross)."""
        count, _, full = alive_set_count(self.alive, self.meta).tolist()
        if full:
            raise RuntimeError(
                "the exact alive set found no free entry: its sizing failed"
            )
        return count


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
    alive: "AliveBitmapState | AliveSetState | None"
    hll: Optional[HLLState]
    quantiles: Optional[DDSketchState]

    @classmethod
    def init(cls, config: AnalyzerConfig, device, alive=None) -> "AnalyzerState":
        """A fresh state; ``alive``, when given, is the alive sub-state to
        hold (an `AliveSetState`) in place of a new dense bitmap."""
        if alive is None and config.count_alive_keys:
            alive = AliveBitmapState.init(config, device)
        return cls(
            metrics=MessageMetricsState.init(config, device),
            alive=alive,
            hll=HLLState.init(config, device) if config.enable_hll else None,
            quantiles=(
                DDSketchState.init(config, device)
                if config.enable_quantiles else None
            ),
        )


_METRIC_LEAVES = tuple(f.name for f in dataclasses.fields(MessageMetricsState))


def substate_nbytes(sub) -> int:
    """Bytes of one sub-state's tensors."""
    return sum(v.nbytes for v in vars(sub).values() if isinstance(v, torch.Tensor))


def state_nbytes(state: AnalyzerState) -> Dict[str, int]:
    """Bytes of the state's tensors by sub-state (``metrics``, ``alive``,
    ``hll``, ``quantiles``; those present), read from the tensors."""
    out = {"metrics": substate_nbytes(state.metrics)}
    for name, sub in (("alive", state.alive), ("hll", state.hll),
                      ("quantiles", state.quantiles)):
        if sub is not None:
            out[name] = substate_nbytes(sub)
    return out

#: Each leaf's merge across device rows (the reference's
#: ``AnalyzerState.merge``): counters and DDSketch buckets add (int64,
#: wrapping like the device adds), extremes take min or max, HLL
#: registers max.  The alive bitmap has none: its last-writer-wins clears
#: resolve only against the data row that set the bit, so its rows OR
#: only at finalize, and never fold into a snapshot.
MERGE_LAW = {
    "metrics.per_partition": np.add,
    "metrics.earliest_s": np.minimum,
    "metrics.latest_s": np.maximum,
    "metrics.smallest": np.minimum,
    "metrics.largest": np.maximum,
    "metrics.overall_size": np.add,
    "metrics.overall_count": np.add,
    "hll.regs": np.maximum,
    "quantiles.counts": np.add,
}


def merge_rows(leaves: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold the leading device axis of stacked host leaves (a mesh
    state's, `state_to_numpy`'s form with one row per shard) into the
    single-device layout, leaf by leaf through `MERGE_LAW`."""
    if "alive.words" in leaves:
        raise ValueError("alive-bitmap rows do not fold: they are mesh-pinned")
    return {
        path: np.asarray(MERGE_LAW[path].reduce(arr, axis=0))
        for path, arr in leaves.items()
    }


def identity_leaves(config: AnalyzerConfig) -> Dict[str, np.ndarray]:
    """The single-device leaves of a fresh state of ``config`` without the
    alive bitmap: each leaf's merge identity (what `MERGE_LAW` leaves
    unchanged), as host arrays."""
    p = config.num_partitions
    out = {
        "metrics.per_partition": np.zeros((p, 7), np.int64),
        "metrics.earliest_s": np.full((p,), I64_MAX, np.int64),
        "metrics.latest_s": np.full((p,), I64_MIN, np.int64),
        "metrics.smallest": np.full((p,), I64_MAX, np.int64),
        "metrics.largest": np.zeros((p,), np.int64),
        "metrics.overall_size": np.zeros((), np.int64),
        "metrics.overall_count": np.zeros((), np.int64),
    }
    if config.enable_hll:
        rows = p if config.distinct_keys_per_partition else 1
        out["hll.regs"] = np.zeros((rows, config.hll_m), np.int32)
    if config.enable_quantiles:
        rows = p if config.quantiles_per_partition else 1
        out["quantiles.counts"] = np.zeros(
            (rows, ddsketch_num_buckets(config.quantile_buckets)), np.int64
        )
    return out


def state_to_numpy(state: AnalyzerState) -> Dict[str, np.ndarray]:
    """Leaf path → host numpy array (a copy), the reference's dtypes
    (alive words as ``uint32``, whichever form holds them)."""
    out = {
        f"metrics.{name}": _host(getattr(state.metrics, name))
        for name in _METRIC_LEAVES
    }
    if state.alive is not None:
        out["alive.words"] = state.alive.host_words()
    if state.hll is not None:
        out["hll.regs"] = _host(state.hll.regs)
    if state.quantiles is not None:
        out["quantiles.counts"] = _host(state.quantiles.counts)
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



def copy_from_numpy_(state: AnalyzerState, leaves: Dict[str, np.ndarray]) -> None:
    """Copy ``leaves`` (`state_to_numpy`'s form) into ``state``'s own
    tensors, in place, on the calling thread's current stream: the same
    tensors, dtypes and device, alive words as ``int32`` bit patterns.
    Raises unless ``leaves`` holds exactly the state's leaves, each of
    the leaf's shape."""
    want = {f"metrics.{name}" for name in _METRIC_LEAVES} | {
        path for path, sub in (("alive.words", state.alive), ("hll.regs", state.hll),
                               ("quantiles.counts", state.quantiles))
        if sub is not None
    }
    if set(leaves) != want:
        raise ValueError(
            f"state leaves {sorted(leaves)} do not match the backend's "
            f"{sorted(want)}"
        )
    for path, arr in leaves.items():
        sub, name = path.split(".")
        dst = getattr(getattr(state, sub), name)
        src = u32_to_i32(arr) if path == "alive.words" else np.require(arr, requirements="C")
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(
                f"state leaf {path} has shape {src.shape}, the backend's "
                f"{tuple(dst.shape)}"
            )
        dst.copy_(torch.from_numpy(src))
