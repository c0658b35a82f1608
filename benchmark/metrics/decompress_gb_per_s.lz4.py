"""Ingest: the LZ4 decoder's rate, the bytes it wrote
(``kta_decompress_out_bytes_total{codec=lz4}``) over its seconds
(``kta_decompress_seconds_total{codec=lz4}``, spans ``decompress``), in GB
(1e9 bytes) a second."""

SECONDS = "kta_decompress_seconds_total{codec=lz4}"
OUT = "kta_decompress_out_bytes_total{codec=lz4}"


def read(layer: dict, config: dict):
    c = layer["counters"]
    seconds, out = c.get(SECONDS), c.get(OUT)
    return out / seconds / 1e9 if out is not None and seconds else None
