"""Drive loop: the share of the dispatch stage's wall its thread ran on a
CPU, ``kta_stage_cpu_seconds_total{stage="dispatch"}`` over
``kta_stage_seconds_total{stage="dispatch"}`` of the window's audits; the
rest less the throttle's wait is the thread's wait for the GIL or the
scheduler."""


def read(layer: dict, config: dict):
    c = layer["counters"]
    cpu = c.get("kta_stage_cpu_seconds_total{stage=dispatch}")
    wall = c.get("kta_stage_seconds_total{stage=dispatch}")
    return cpu / wall if cpu is not None and wall else None
