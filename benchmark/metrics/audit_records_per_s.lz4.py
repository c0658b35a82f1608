"""CLI: the audits' rate in the LZ4 cell, as ``audit_records_per_s.scan``
reads it: the records of every audit of the window that exited 0 over the
time from the window's start to the end of its last audit (host clock)."""

from benchmark.run import load_reader

read = load_reader("audit_records_per_s.scan")
