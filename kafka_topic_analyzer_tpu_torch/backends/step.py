"""The analyzer step: fold one batch and its pair table into the state
(port of the reference's ``analyzer_step``, ``_analyzer_step_v5``,
``_apply_alive`` and ``apply_pair_table``, without the mesh branches).

Under wire v5 every fold is an elementwise table merge — integer adds for
the counters and DDSketch buckets, min/max for the extremes, max for HLL
registers.  Under wire v4 the device scatters the records' columns into
the same tables.  Either way the result is exact and order-free except
for the alive bitmap, whose last-writer-wins order the host already
resolved in the pairs (per row, or compacted per dispatch).

The reference's step is pure (XLA donates its buffers); the port updates
the caller's state in place and returns it.
"""

from __future__ import annotations

import torch

from kafka_topic_analyzer_tpu_torch._torch_support import u32_low_bits
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.models.state import AnalyzerState
from kafka_topic_analyzer_tpu_torch.ops.bitmap import (
    bitmap_apply_masks,
    bitmap_apply_pairs,
)
from kafka_topic_analyzer_tpu_torch.ops.counters import extremes_update
from kafka_topic_analyzer_tpu_torch.ops.counters_merge import counters_merge
from kafka_topic_analyzer_tpu_torch.ops.counters_update import counters_update
from kafka_topic_analyzer_tpu_torch.ops.ddsketch import ddsketch_merge, ddsketch_update
from kafka_topic_analyzer_tpu_torch.ops.hll import (
    hll_apply,
    hll_apply_flat,
    hll_merge_table,
)


def apply_pair_table(
    state: AnalyzerState,
    pairs: dict,
    config: AnalyzerConfig,
    scratch: "torch.Tensor | None" = None,
) -> AnalyzerState:
    """Apply one dispatch's compacted alive table
    (`packing.unpack_pair_table_device`): set/clear word masks merge
    elementwise; the bounded pair list goes through the pair scatter
    (``scratch``: see `ops.bitmap.bitmap_scratch`)."""
    if state.alive is None:
        return state
    if "alive_set" in pairs:
        bitmap_apply_masks(
            state.alive.words, pairs["alive_set"], pairs["alive_clear"]
        )
    else:
        bitmap_apply_pairs(
            state.alive.words,
            pairs["alive_slot"],
            pairs["alive_flag"],
            pairs["n_pairs"],
            bits=config.alive_bitmap_bits,
            scratch=scratch,
        )
    return state


def _apply_alive(
    state: AnalyzerState,
    arrays: dict,
    config: AnalyzerConfig,
    scratch: "torch.Tensor | None",
) -> None:
    """Apply a row's per-row alive pairs (compaction off, both wire
    formats), in place."""
    if state.alive is not None and "alive_slot" in arrays:
        bitmap_apply_pairs(
            state.alive.words,
            arrays["alive_slot"],
            arrays["alive_flag"],
            arrays["n_pairs"],
            bits=config.alive_bitmap_bits,
            scratch=scratch,
        )


def analyzer_step_v5(
    state: AnalyzerState,
    arrays: dict,
    config: AnalyzerConfig,
    scratch: "torch.Tensor | None" = None,
) -> AnalyzerState:
    """Wire-v5 fold of one unpacked batch (`packing.unpack_device`).  The
    counter-table merge always runs through `counters_merge` — the CUDA
    kernel on a card, its plain version on the host — and adds the global
    sums (column sums of the delta table: channels 5/6 are the key/value
    byte sums, channel 0 the record count) in the same call."""
    m = state.metrics
    counters_merge(
        m.per_partition, arrays["counts"],  # int64[P, 7], COUNTER_CHANNELS order
        overall_size=m.overall_size, overall_count=m.overall_count,
    )
    m.earliest_s, m.latest_s, m.smallest, m.largest = extremes_update(
        m.earliest_s, m.latest_s, m.smallest, m.largest,
        arrays["ts_min"], arrays["ts_max"], arrays["sz_min"], arrays["sz_max"],
    )
    _apply_alive(state, arrays, config, scratch)

    if state.hll is not None:
        regs = state.hll.regs
        if "hll_regs" in arrays:
            hll_merge_table(regs, arrays["hll_regs"])
        elif "hll_idx32" in arrays:
            # The index already encodes (row << p | bucket).
            hll_apply_flat(regs, u32_low_bits(arrays["hll_idx32"]), arrays["hll_rho"])
        else:
            hll_apply_flat(
                regs, arrays["hll_idx"].to(torch.int64) & 0xFFFF, arrays["hll_rho"]
            )

    if state.quantiles is not None:
        ddsketch_merge(state.quantiles.counts, arrays["qcounts"])
    return state


def analyzer_step(
    state: AnalyzerState,
    arrays: dict,
    config: AnalyzerConfig,
    scratch: "torch.Tensor | None" = None,
) -> AnalyzerState:
    """Fold one unpacked batch into the state, in place; returns it.
    Wire-v5 rows (a ``counts`` table present) take `analyzer_step_v5`;
    wire-v4 rows scatter their record columns here.  The v4 counter
    update always runs through `counters_update` — the CUDA kernel on a
    card, its plain version on the host — and adds the global sums in the
    same call.  ``scratch`` is the pair
    scatter's accumulator (`ops.bitmap.bitmap_scratch`) for per-row
    alive pairs."""
    if "counts" in arrays:
        return analyzer_step_v5(state, arrays, config, scratch)
    valid = arrays["valid"]
    key_null = arrays["key_null"]
    value_null = arrays["value_null"]
    key_len = arrays["key_len"]
    value_len = arrays["value_len"]
    partition = arrays["partition"]

    m = state.metrics
    counters_update(
        m.per_partition, partition, key_len, value_len, key_null, value_null,
        valid, config.num_partitions,
        overall_size=m.overall_size, overall_count=m.overall_count,
    )
    m.earliest_s, m.latest_s, m.smallest, m.largest = extremes_update(
        m.earliest_s, m.latest_s, m.smallest, m.largest,
        arrays["ts_min"], arrays["ts_max"], arrays["sz_min"], arrays["sz_max"],
    )
    _apply_alive(state, arrays, config, scratch)

    if state.hll is not None:
        regs = state.hll.regs
        if "hll_regs" in arrays:
            hll_merge_table(regs, arrays["hll_regs"])
        else:
            hll_apply(
                regs,
                arrays["hll_idx"].to(torch.int64) & 0xFFFF,
                arrays["hll_rho"],
                partition=(
                    partition if config.distinct_keys_per_partition else None
                ),
            )

    if state.quantiles is not None:
        # Quantiles run over sized (non-tombstone) messages.
        kn = valid & ~key_null
        vn = valid & ~value_null
        msg_size = (
            torch.where(kn, key_len, 0).to(torch.int64)
            + torch.where(vn, value_len, 0).to(torch.int64)
        )
        ddsketch_update(
            state.quantiles.counts,
            msg_size,
            vn,
            config.quantile_gamma,
            config.quantile_buckets,
            partition=partition if config.quantiles_per_partition else None,
        )
    return state
