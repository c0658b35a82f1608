"""Device: the most device-resident bytes the process's live backends held
at once, ``kta_device_resident_bytes_max`` at the window's close (set-up
included, as the memory peak is): a fleet keeps every topic's backend for
its life."""


def read(layer: dict, config: dict):
    value = layer.get("gauges", {}).get("kta_device_resident_bytes_max")
    return value if value else None
