"""Ingest staging (port of the reference's ``parallel`` package, its
single-stream part)."""
