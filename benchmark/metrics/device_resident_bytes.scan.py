"""Device: the bytes an audit's backend keeps on the device for its life
(its state's tensors and the bitmap's scratch), the summed
``kta_device_resident_bytes_total`` over the window's finalizes
(``kta_backend_finalize_seconds``: one backend an audit)."""

PREFIX = "kta_device_resident_bytes_total{"


def read(layer: dict, config: dict):
    c = layer["counters"]
    owners = [v for k, v in c.items() if k.startswith(PREFIX)]
    n = c.get("kta_backend_finalize_seconds:count", 0.0)
    return sum(owners) / n if owners and n > 0 else None
