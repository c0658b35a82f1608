"""Finalize: mean seconds of a topic backend's finalize (one a topic pass),
``kta_backend_finalize_seconds`` over the window."""


def read(layer: dict, config: dict):
    c = layer["counters"]
    n = c.get("kta_backend_finalize_seconds:count", 0.0)
    return c["kta_backend_finalize_seconds:sum"] / n if n > 0 else None
