"""Service: the 95th percentile (nearest rank) over the window's SSE frames
of their arrival at the client less the document's publish time, as
``delivery_ms_p95.follow`` reads it, in the keyless follow cell."""

from benchmark.run import load_reader

read = load_reader("delivery_ms_p95.follow")
