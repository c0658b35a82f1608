"""PyTorch/CUDA port of the Kafka topic analyzer.

A second package beside the JAX reference (``kafka_topic_analyzer_tpu``):
the same scan, state and report, with device work in PyTorch and the
counter-table merge in a hand-written CUDA kernel for Hopper
(`ops/counters_merge.py`).  Module names mirror the reference so each
counterpart is easy to find.  The port imports ``torch`` and numpy, never
``jax`` and nothing of the reference package: it keeps its own copies of
the host code it needs.

Ported so far (wire format v5 with alive-pair compaction, one device,
superbatch K=1): synthetic source → v5 pack + pair table → H2D → table
merge → finalize → report (`cli.py`, ``python -m
kafka_topic_analyzer_tpu_torch``).
"""

__version__ = "0.1.0"
