"""HyperLogLog distinct-key sketch (port of the reference's ``ops/hll.py``).

Device half: the register file is ``int32[R, 2^p]``; a batch arrives
either as a host-reduced register table (merged by elementwise max) or as
``(index, rho)`` pairs (one scatter-max, ``scatter_reduce("amax")``),
flat or with the row taken from the partition column (wire v4).  Masked
records carry ``(0, 0)``, a no-op under max.

Host half: Ertl's improved raw estimator (2017), copied from the
reference so the estimates are bit-identical.
"""

from __future__ import annotations

import numpy as np
import torch


def hll_merge_table(regs: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Merge a host-reduced ``uint8[R << p]`` register table into
    ``regs`` in place (register max is commutative)."""
    return torch.maximum(
        regs, table.to(torch.int32).view(regs.shape), out=regs
    )


def hll_apply_flat(
    regs: torch.Tensor, idx: torch.Tensor, rho: torch.Tensor
) -> torch.Tensor:
    """Scatter-max flat HLL pairs into ``regs`` in place.  ``idx`` is the
    flat register index (``row << p | bucket`` for wire-v5 per-partition
    pairs, the bare bucket for the global row) as int64; ``rho`` u8."""
    regs.view(-1).scatter_reduce_(
        0, idx, rho.to(torch.int32), reduce="amax", include_self=True
    )
    return regs


def hll_apply(
    regs: torch.Tensor,
    idx: torch.Tensor,
    rho: torch.Tensor,
    partition: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Scatter-max host pre-split HLL pairs into ``regs`` in place: with
    ``partition`` given each record updates its partition's row (R = P),
    otherwise the single row.  ``idx`` is the bucket index as int64 (the
    u16 section's bit pattern already masked to 0..2^16-1)."""
    if partition is not None:
        idx = partition.to(torch.int64) * regs.shape[1] + idx
    return hll_apply_flat(regs, idx, rho)


def _sigma(x: float) -> float:
    """Ertl 2017 eq. (14): power series for the register-value-0 term."""
    if x == 1.0:
        return float("inf")
    y = 1.0
    z = x
    while True:
        x = x * x
        z_prev = z
        z = z + x * y
        y = 2.0 * y
        if z == z_prev:
            return z


def _tau(x: float) -> float:
    """Ertl 2017 eq. (23): power series for the saturated-register term."""
    if x == 0.0 or x == 1.0:
        return 0.0
    y = 1.0
    z = 1.0 - x
    while True:
        x = np.sqrt(x)
        z_prev = z
        y = 0.5 * y
        z = z - (1.0 - x) ** 2 * y
        if z == z_prev:
            return z / 3.0


def hll_estimate(regs: np.ndarray) -> float:
    """Host-side cardinality estimate from final registers: Ertl's
    improved raw estimator (2017, algorithm 6) over the register
    histogram."""
    regs = np.asarray(regs)
    m = regs.shape[0]
    if m & (m - 1):
        raise ValueError("register count must be a power of two")
    p = int(m).bit_length() - 1
    q = 64 - p  # max rho is q + 1
    counts = np.bincount(regs.astype(np.int64), minlength=q + 2)
    z = m * _tau(1.0 - counts[q + 1] / m)
    for k in range(q, 0, -1):
        z = 0.5 * (z + float(counts[k]))
    z = z + m * _sigma(counts[0] / m)
    alpha_inf = 0.5 / np.log(2.0)
    return float(alpha_inf * m * m / z)
