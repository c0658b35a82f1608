"""The key hashes of the analyzer's report, in plain numpy.

- ``fnv32_variant``: xenji/kafka-topic-analyzer's alive-key slot hash
  (``src/fnv32.rs``), FNV-1a over the key bytes that multiplies by the
  offset basis 0x811c9dc5 instead of the FNV prime. Its collisions are part
  of the report: two keys in one slot are one alive key.
- ``fnv1a64``: the standard 64-bit FNV-1a, and ``splitmix64`` the finalizer
  applied to it before a HyperLogLog register is chosen.

Each takes a ``uint8[N, L]`` matrix of keys of one length ``L``.
"""

from __future__ import annotations

import numpy as np

FNV32_BASIS = np.uint32(0x811C9DC5)
FNV64_BASIS = np.uint64(0xCBF29CE484222325)
FNV64_PRIME = np.uint64(0x100000001B3)


def fnv32_variant(keys: np.ndarray) -> np.ndarray:
    h = np.full(keys.shape[0], FNV32_BASIS, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for col in range(keys.shape[1]):
            h = (h ^ keys[:, col].astype(np.uint32)) * FNV32_BASIS
    return h


def fnv1a64(keys: np.ndarray) -> np.ndarray:
    h = np.full(keys.shape[0], FNV64_BASIS, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for col in range(keys.shape[1]):
            h = (h ^ keys[:, col].astype(np.uint64)) * FNV64_PRIME
    return h


def splitmix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x += np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))
