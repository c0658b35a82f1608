"""Ingest: the share of its life each parallel-ingest worker spent not
blocked on its full fan-in queue, ``(active - stall) / active`` from the
program's ``kta_ingest_worker_{active,stall}_seconds_total``, averaged over
the workers, over the window's audits."""


def read(layer: dict, config: dict):
    c = layer["counters"]
    shares = []
    prefix = "kta_ingest_worker_active_seconds_total{"
    for key, active in c.items():
        if key.startswith(prefix) and active > 0:
            stall = c.get(key.replace("_active_", "_stall_"), 0.0)
            shares.append((active - stall) / active)
    return sum(shares) / len(shares) if shares else None
