"""Ingest: the share of their lives the parallel-ingest workers' threads
ran on a CPU, the summed ``kta_ingest_worker_cpu_seconds_total`` over the
summed ``kta_ingest_worker_active_seconds_total`` (the same windows) of the
window's audits; the rest is waiting: sockets, the GIL, a full queue."""

ACTIVE = "kta_ingest_worker_active_seconds_total{"
CPU = "kta_ingest_worker_cpu_seconds_total{"


def read(layer: dict, config: dict):
    c = layer["counters"]
    cpu = [v for k, v in c.items() if k.startswith(CPU)]
    active = sum(v for k, v in c.items() if k.startswith(ACTIVE))
    return sum(cpu) / active if cpu and active > 0 else None
