"""Finalize: mean seconds an audit of finalize's derivation on the host
(the bitmap's popcount, the sketch estimates),
``kta_finalize_phase_seconds_total{phase="derive"}`` over the window's
finalizes (``kta_backend_finalize_seconds``)."""


def read(layer: dict, config: dict):
    c = layer["counters"]
    derive = c.get("kta_finalize_phase_seconds_total{phase=derive}")
    n = c.get("kta_backend_finalize_seconds:count", 0.0)
    return derive / n if derive is not None and n > 0 else None
