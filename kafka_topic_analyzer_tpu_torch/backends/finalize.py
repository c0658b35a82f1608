"""Turn host state leaves into TopicMetrics (port of the reference's
``backends/finalize.py``).  Popcount and the sketch estimates run on the
host, on the `models.state.state_to_numpy` leaves."""

from __future__ import annotations

import numpy as np

from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.ops.ddsketch import ddsketch_quantiles
from kafka_topic_analyzer_tpu_torch.ops.hll import hll_estimate
from kafka_topic_analyzer_tpu_torch.results import (
    QUANTILE_PROBS,
    QuantileSummary,
    TopicMetrics,
    finalize_extremes,
)


def metrics_from_state(
    leaves: "dict[str, np.ndarray]", config: AnalyzerConfig, init_now_s: int
) -> TopicMetrics:
    """``leaves`` is a `state_to_numpy` dict."""
    earliest_s = leaves["metrics.earliest_s"]
    latest_s = leaves["metrics.latest_s"]
    smallest_s = leaves["metrics.smallest"]
    largest_s = leaves["metrics.largest"]
    # Per-partition extremes reduce to the reference's global lines.
    earliest, latest, smallest = finalize_extremes(
        int(np.min(earliest_s)),
        int(np.max(latest_s)),
        int(np.min(smallest_s)),
        init_now_s,
    )
    extremes = np.stack([earliest_s, latest_s, smallest_s, largest_s], axis=1)
    alive_keys = None
    if "alive.words" in leaves:
        alive_keys = int(np.bitwise_count(leaves["alive.words"]).sum())
    hll = None
    hll_pp = None
    if "hll.regs" in leaves:
        regs = leaves["hll.regs"]
        # Global estimate from the union of rows (elementwise max is the
        # HLL merge); per-partition estimates from each row.
        hll = hll_estimate(regs.max(axis=0))
        if config.distinct_keys_per_partition:
            hll_pp = [hll_estimate(regs[r]) for r in range(regs.shape[0])]
    quantiles = None
    quantiles_pp = None
    if "quantiles.counts" in leaves:
        counts = leaves["quantiles.counts"]
        # Global quantiles from the exact sum of rows (DDSketch merge = add).
        vals = ddsketch_quantiles(
            counts.sum(axis=0), QUANTILE_PROBS, config.quantile_gamma
        )
        quantiles = QuantileSummary(list(QUANTILE_PROBS), vals)
        if config.quantiles_per_partition:
            quantiles_pp = [
                QuantileSummary(
                    list(QUANTILE_PROBS),
                    ddsketch_quantiles(
                        counts[r], QUANTILE_PROBS, config.quantile_gamma
                    ),
                )
                for r in range(counts.shape[0])
            ]
    return TopicMetrics(
        partitions=list(range(config.num_partitions)),
        per_partition=leaves["metrics.per_partition"],
        earliest_ts_s=earliest,
        latest_ts_s=latest,
        smallest_message=smallest,
        largest_message=int(np.max(largest_s)),
        overall_size=int(leaves["metrics.overall_size"]),
        overall_count=int(leaves["metrics.overall_count"]),
        alive_keys=alive_keys,
        distinct_keys_hll=hll,
        distinct_keys_hll_per_partition=hll_pp,
        quantiles=quantiles,
        quantiles_per_partition=quantiles_pp,
        per_partition_extremes=extremes,
        init_now_s=init_now_s,
    )
