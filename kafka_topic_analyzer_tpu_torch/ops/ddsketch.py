"""DDSketch message-size quantiles (port of the reference's
``ops/ddsketch.py``).

The host half — the shared integer bucket-edge table, the packer's bucket
rule and the quantile extraction — is copied from the reference, so the
wire-v5 bucket counts and the reported quantiles are bit-identical.  The
device half under wire v5 is a plain row add (`ddsketch_merge`): the host
already reduced each batch to per-row bucket counts.

Bucket layout for non-negative integer sizes: bucket 0 holds size 0,
buckets 1..nbuckets the log-gamma ranges, bucket nbuckets+1 the overflow.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def ddsketch_num_buckets(nbuckets: int) -> int:
    return nbuckets + 2  # zero bucket + log buckets + overflow


@functools.lru_cache(maxsize=8)
def ddsketch_edges(gamma: float, nbuckets: int) -> np.ndarray:
    """Integer bucket boundaries: ``edges[i]`` is the largest integer size
    assigned to log bucket ``i + 1``, i.e. ``floor(gamma^i)``.  The bucket
    of a size ``s >= 1`` is ``searchsorted(edges, s, side='left') + 1``,
    saturating at the overflow bucket.  An integer comparison is exact on
    every backend, which is what lets the host pre-reduce the histogram."""
    powers = np.power(np.float64(gamma), np.arange(nbuckets, dtype=np.float64))
    # Clip before the int cast: gamma^i can pass 2^63 for extreme
    # (alpha, nbuckets); any edge above 2^62 is unreachable anyway.
    edges = np.floor(np.minimum(powers, 2.0**62)).astype(np.int64)
    edges.setflags(write=False)
    return edges


def ddsketch_bucket_numpy(
    sizes: np.ndarray, gamma: float, nbuckets: int
) -> np.ndarray:
    """Host-side bucket index per size (the wire-v5 packer's reduction):
    0 for size 0, the shared edge-table bucket otherwise."""
    idx = np.searchsorted(
        ddsketch_edges(gamma, nbuckets), sizes, side="left"
    ).astype(np.int64) + 1
    return np.where(sizes == 0, 0, idx)


def ddsketch_merge(counts: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Fold a batch's bucket-count table into the state, in place
    (DDSketch rows merge by addition)."""
    return counts.add_(delta)


def ddsketch_quantiles(counts: np.ndarray, probs, gamma: float) -> "list[float]":
    """Host-side quantile extraction from final bucket counts."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    out: "list[float]" = []
    if total == 0:
        return [float("nan") for _ in probs]
    cum = np.cumsum(counts)
    nbuckets = counts.shape[0] - 2
    for q in probs:
        rank = max(0, min(total - 1, int(np.ceil(q * total)) - 1))
        b = int(np.searchsorted(cum, rank + 1))
        if b == 0:
            out.append(0.0)
        elif b > nbuckets:
            out.append(float("inf"))
        else:
            # midpoint of (gamma^(b-2), gamma^(b-1)]: 2*gamma^(b-1)/(gamma+1)
            out.append(float(2.0 * gamma ** (b - 1) / (gamma + 1.0)))
    return out
