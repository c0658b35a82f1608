"""Device: seconds an audit of the exact alive set's grows, the program's
``kta_alive_grow_seconds_total`` (spans ``alive-grow``: the larger table's
allocation and its rehash's launch, on the host) over the window's
finalizes (``kta_backend_finalize_seconds``: one an audit)."""


def read(layer: dict, config: dict):
    c = layer["counters"]
    seconds = c.get("kta_alive_grow_seconds_total")
    n = c.get("kta_backend_finalize_seconds:count", 0.0)
    return seconds / n if seconds is not None and n > 0 else None
