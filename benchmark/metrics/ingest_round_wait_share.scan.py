"""Ingest: the share of the parallel-ingest workers' lives their wire
streams spent blocked on fetch rounds' responses,
``kta_ingest_round_wait_seconds_total`` over the summed
``kta_ingest_worker_active_seconds_total`` of the window's audits."""

ACTIVE = "kta_ingest_worker_active_seconds_total{"


def read(layer: dict, config: dict):
    c = layer["counters"]
    wait = c.get("kta_ingest_round_wait_seconds_total")
    active = sum(v for k, v in c.items() if k.startswith(ACTIVE))
    return wait / active if wait is not None and active > 0 else None
