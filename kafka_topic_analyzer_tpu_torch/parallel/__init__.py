"""Ingest staging and partition-sharded parallel ingest (port of the
reference's ``parallel`` package, its single-device part)."""
