"""Device: seconds an audit of the exact alive set's switch to the dense
bitmap, the program's ``kta_alive_switch_seconds_total`` (span
``alive-switch``: the set's copy to the host, its alive slots derived
there, their load into the bitmap) over the window's finalizes
(``kta_backend_finalize_seconds``: one an audit)."""


def read(layer: dict, config: dict):
    c = layer["counters"]
    seconds = c.get("kta_alive_switch_seconds_total")
    n = c.get("kta_backend_finalize_seconds:count", 0.0)
    return seconds / n if seconds is not None and n > 0 else None
