"""Fleet mode: one service scans a cluster's topics (port of the
reference's ``fleet/`` package).

``discovery`` turns cluster metadata into a filtered topic list,
``scheduler`` shares the global ingest-worker and dispatch-depth budgets
across concurrent per-topic scans, ``lease`` arbitrates topic ownership
between analyzer instances, ``report`` builds the cluster rollup, and
``service`` drives the admitted scans: each one the same
``engine.run_scan`` pass chain as a solo scan of that topic, on a backend
of its own (on the card, on a CUDA stream of its own).
"""
