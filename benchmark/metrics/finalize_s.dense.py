"""Finalize: mean seconds of the backend's finalize per audit,
``kta_backend_finalize_seconds``, as ``finalize_s.scan`` reads it: in the
published-keys cell the dense bitmap's 512 MiB copy to the host and its
popcount there."""

from benchmark.run import load_reader

read = load_reader("finalize_s.scan")
