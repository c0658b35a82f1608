"""Ingest: the share of the ingest workers' lives spent in the per-frame
chain that takes the frames the fused decode->pack walk stops at
(``kta_frame_fallback_seconds_total``, spans ``frame-fallback``: each
frame's parse and decompression, its record decode and its rows' append)
over the summed ``kta_ingest_worker_active_seconds_total`` of the window's
audits."""

SECONDS = "kta_frame_fallback_seconds_total"
ACTIVE = "kta_ingest_worker_active_seconds_total{"


def read(layer: dict, config: dict):
    c = layer["counters"]
    seconds = c.get(SECONDS)
    active = sum(v for k, v in c.items() if k.startswith(ACTIVE))
    return seconds / active if seconds is not None and active > 0 else None
