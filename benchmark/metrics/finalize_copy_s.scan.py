"""Finalize: mean seconds an audit of finalize's copy of the state to the
host, ``kta_finalize_phase_seconds_total{phase="copy"}`` over the window's
finalizes (``kta_backend_finalize_seconds``)."""


def read(layer: dict, config: dict):
    c = layer["counters"]
    copy = c.get("kta_finalize_phase_seconds_total{phase=copy}")
    n = c.get("kta_backend_finalize_seconds:count", 0.0)
    return copy / n if copy is not None and n > 0 else None
