"""Ingest: the share of the records packed into rows that came through the
fused decode->pack walk. The program books every record of a completed
row on ``kta_fused_records_total``, whichever way it entered the row, and
the records that entered through the per-frame chain also on
``kta_fused_fallback_total`` (by reason): the walk's own records are the
first less the second, here over the first."""

ROWS = "kta_fused_records_total"
FALLBACK = "kta_fused_fallback_total{"


def read(layer: dict, config: dict):
    c = layer["counters"]
    rows = c.get(ROWS)
    if not rows:
        return None
    fallback = sum(v for k, v in c.items() if k.startswith(FALLBACK))
    return (rows - fallback) / rows
