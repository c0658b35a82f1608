"""Ingest: the share of the ingest workers' lives spent decompressing LZ4
frames, the program's ``kta_decompress_seconds_total{codec=lz4}`` (spans
``decompress``) over the summed ``kta_ingest_worker_active_seconds_total``
of the window's audits."""

SECONDS = "kta_decompress_seconds_total{codec=lz4}"
ACTIVE = "kta_ingest_worker_active_seconds_total{"


def read(layer: dict, config: dict):
    c = layer["counters"]
    seconds = c.get(SECONDS)
    active = sum(v for k, v in c.items() if k.startswith(ACTIVE))
    return seconds / active if seconds is not None and active > 0 else None
