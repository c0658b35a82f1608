"""DDSketch message-size quantiles (port of the reference's
``ops/ddsketch.py``).

The host half — the shared integer bucket-edge table, the packer's bucket
rule and the quantile extraction — is copied from the reference, so the
wire-v5 bucket counts and the reported quantiles are bit-identical.  The
device half under wire v5 is a plain row add (`ddsketch_merge`): the host
already reduced each batch to per-row bucket counts.  Under wire v4 the
device buckets each record on the same edge table and scatter-adds it
(`ddsketch_update`).

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


@functools.lru_cache(maxsize=8)
def _edges_on(gamma: float, nbuckets: int, device: torch.device) -> torch.Tensor:
    """The edge table as a tensor on ``device``, copied there once."""
    return torch.from_numpy(ddsketch_edges(gamma, nbuckets).copy()).to(device)


def ddsketch_update(
    counts: torch.Tensor,      # int64[R, nbuckets + 2]
    sizes: torch.Tensor,       # int64[B] message sizes
    active: torch.Tensor,      # bool[B] records that count
    gamma: float,
    nbuckets: int,
    partition: "torch.Tensor | None" = None,  # int32[B] row per record
) -> torch.Tensor:
    """Scatter-add one batch of sizes into the bucket counts, in place.
    Buckets come from the shared integer edge table (``searchsorted``
    left), so they equal the host packer's; masked records go to a
    scratch slot that is dropped.  ``partition`` picks each record's row
    (R = P); without it every record lands in the single row."""
    nb = nbuckets + 2
    rows = counts.shape[0]
    idx = torch.searchsorted(
        _edges_on(gamma, nbuckets, sizes.device), sizes, right=False
    ) + 1
    idx = torch.where(sizes == 0, 0, idx)
    flat = idx if partition is None else partition.to(torch.int64) * nb + idx
    flat = torch.where(active, flat, rows * nb)
    scratch = torch.zeros(rows * nb + 1, dtype=torch.int64, device=counts.device)
    scratch.index_add_(0, flat, torch.ones_like(flat))
    return counts.add_(scratch[: rows * nb].view(rows, nb))


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
