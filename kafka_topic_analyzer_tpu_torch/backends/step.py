"""The analyzer step: fold one wire-v5 batch and its pair table into the
state (port of the reference's ``_analyzer_step_v5`` and
``apply_pair_table``).

Every fold is an elementwise table merge — integer adds for the counters
and DDSketch buckets, min/max for the extremes, max for HLL registers —
so the result is exact and order-free except for the alive bitmap, whose
last-writer-wins order the host already resolved in the pair table.

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
from kafka_topic_analyzer_tpu_torch.ops.ddsketch import ddsketch_merge
from kafka_topic_analyzer_tpu_torch.ops.hll import hll_apply_flat, hll_merge_table


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


def analyzer_step_v5(
    state: AnalyzerState, arrays: dict, config: AnalyzerConfig
) -> AnalyzerState:
    """Wire-v5 fold of one unpacked batch (`packing.unpack_device`).  The
    counter-table merge always runs through `counters_merge` — the CUDA
    kernel on a card, its plain version on the host."""
    m = state.metrics
    delta = arrays["counts"]  # int64[P, 7], COUNTER_CHANNELS order
    counters_merge(m.per_partition, delta)
    m.earliest_s, m.latest_s, m.smallest, m.largest = extremes_update(
        m.earliest_s, m.latest_s, m.smallest, m.largest,
        arrays["ts_min"], arrays["ts_max"], arrays["sz_min"], arrays["sz_max"],
    )
    # Global sums are column sums of the delta table: channels 5/6 are the
    # key/value byte sums, channel 0 the record count.
    m.overall_size.add_((delta[:, 5] + delta[:, 6]).sum())
    m.overall_count.add_(delta[:, 0].sum())

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
