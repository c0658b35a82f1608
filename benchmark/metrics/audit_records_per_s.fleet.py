"""CLI: the fleet audits' rate, the records of every topic of every audit of
the window that exited 0 over the time from the window's start to the end
of its last audit (host clock)."""


def read(layer: dict, config: dict):
    window = layer.get("window_s")
    return layer["records"] / window if window else None
