"""Kernels: device milliseconds a dispatch from the fold's first launch to
its completion (two timing events on the backend's stream, waits for the
host's next launch within the fold included), the program's
``kta_fold_device_seconds_total`` over the window's dispatches
(``kta_dispatch_seconds``)."""


def read(layer: dict, config: dict):
    c = layer["counters"]
    seconds = c.get("kta_fold_device_seconds_total")
    n = c.get("kta_dispatch_seconds:count", 0.0)
    return seconds * 1e3 / n if seconds is not None and n > 0 else None
