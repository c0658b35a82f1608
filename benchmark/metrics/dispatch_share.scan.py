"""Drive loop: the drive loop's dispatch stage, ``kta_stage_seconds_total
{stage="dispatch"}``, over the summed wall time of the window's audits."""


def read(layer: dict, config: dict):
    dispatch = layer["counters"].get("kta_stage_seconds_total{stage=dispatch}")
    wall = sum(layer["walls"])
    return dispatch / wall if dispatch is not None and wall > 0 else None
