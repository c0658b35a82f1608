"""PyTorch/CUDA port of the Kafka topic analyzer.

A second package beside the JAX reference (``kafka_topic_analyzer_tpu``):
the same scan, state and report, with device work in PyTorch and the
counter-table merge in a hand-written CUDA kernel for Hopper
(`ops/counters_merge.py`).  Module names mirror the reference so each
counterpart is easy to find.  The port imports ``torch`` and numpy, never
``jax`` and nothing of the reference package: it keeps its own copies of
the host code it needs.

Ported so far (one device): the Kafka wire, synthetic and segment-file
sources (a local directory or a remote object store) → wire v5 or v4 rows
(numpy, the native shim, or fused decode→pack into pinned memory) → H2D →
the counter kernels (`ops/counters_merge.py`, `ops/counters_update.py`)
and the sketch folds, one row or a superbatch of K rows per dispatch →
finalize → report or ``--json`` document (`cli.py`,
``python -m kafka_topic_analyzer_tpu_torch``).
"""

__version__ = "0.1.0"
