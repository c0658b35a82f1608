"""FNV-1a and SplitMix64 hashing, batch-vectorized in numpy (copied from
the reference's ``ops/fnv.py``).

xenji/kafka-topic-analyzer's 32-bit FNV-1a *variant* (``src/fnv32.rs``)
multiplies by the offset basis ``0x811c9dc5`` instead of the FNV prime;
its alive-key bitset indexes by that hash, so its collisions are part of
the observable output and `fnv1a32_ref_batch` reproduces it bit for bit.
The standard 64-bit FNV-1a (`fnv1a64_batch`) feeds the HLL sketches.
Batch forms take a padded ``uint8[B, L]`` key matrix plus a length vector.
"""

from __future__ import annotations

import numpy as np

FNV32_OFFSET = np.uint32(0x811C9DC5)
# The reference multiplies by the offset basis, NOT the FNV prime 0x01000193.
FNV32_MULT = np.uint32(0x811C9DC5)

FNV64_OFFSET = np.uint64(0xCBF29CE484222325)
FNV64_PRIME = np.uint64(0x100000001B3)


_U64_MASK = (1 << 64) - 1


def splitmix64(x: int) -> int:
    """SplitMix64 finalizer over one Python int (the multi-topic fan-in's
    per-topic slot salt)."""
    x = (x + 0x9E3779B97F4A7C15) & _U64_MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64_MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64_MASK
    return x ^ (x >> 31)


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Vectorized SplitMix64 over a uint64 array."""
    x = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x += np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def fnv1a32_ref_batch(padded: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized bug-compatible FNV-1a-32 over ``uint8[B, L]`` rows.

    Row ``i`` hashes ``padded[i, :lengths[i]]``.  Columns are processed in a
    short Python loop of length ``L`` (max key length), each step fully
    vectorized over the batch — the per-byte recurrence is inherently
    sequential, the batch axis is not.
    """
    padded = np.ascontiguousarray(padded, dtype=np.uint8)
    lengths = np.asarray(lengths)
    h = np.full(padded.shape[0], FNV32_OFFSET, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for col in range(padded.shape[1]):
            active = lengths > col
            nh = (h ^ padded[:, col]) * FNV32_MULT
            h = np.where(active, nh, h)
    return h


def fnv1a64_batch(padded: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized standard FNV-1a-64 over ``uint8[B, L]`` rows."""
    padded = np.ascontiguousarray(padded, dtype=np.uint8)
    lengths = np.asarray(lengths)
    h = np.full(padded.shape[0], FNV64_OFFSET, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for col in range(padded.shape[1]):
            active = lengths > col
            nh = (h ^ padded[:, col].astype(np.uint64)) * FNV64_PRIME
            h = np.where(active, nh, h)
    return h
