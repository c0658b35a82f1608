"""Exact counter sentinels and the extremes merge (port of the
reference's ``ops/counters.py``).

Per-partition timestamp and size extremes arrive host-reduced
(``packing.ts_minmax_table`` / ``sz_minmax_table``), so the device merge
is an elementwise min/max against the state.  The counter-table add lives
in `ops/counters_merge.py` (the hand-written kernel).
"""

from __future__ import annotations

import numpy as np
import torch

#: Sentinel for "never seen" minima (reported as the reference's u64::MAX
#: rule at finalize).
I64_MAX = int(np.iinfo(np.int64).max)
I64_MIN = int(np.iinfo(np.int64).min)


def extremes_update(
    earliest_s: torch.Tensor,  # int64[P], I64_MAX sentinel when unset
    latest_s: torch.Tensor,    # int64[P], I64_MIN sentinel
    smallest: torch.Tensor,    # int64[P], I64_MAX sentinel
    largest: torch.Tensor,     # int64[P]
    ts_min: torch.Tensor,      # int64[P], host-pre-reduced
    ts_max: torch.Tensor,
    sz_min: torch.Tensor,
    sz_max: torch.Tensor,
):
    """Merge per-partition timestamp and message-size extremes; returns
    the four merged tensors (min/max is associative, so merging batch
    tables elementwise is exact)."""
    return (
        torch.minimum(earliest_s, ts_min),
        torch.maximum(latest_s, ts_max),
        torch.minimum(smallest, sz_min),
        torch.maximum(largest, sz_max),
    )
