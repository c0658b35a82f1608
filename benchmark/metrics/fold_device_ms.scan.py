"""Kernels: device milliseconds a dispatch, the fold's own: every kernel,
copy and memset of the traced window that ran while the drive loop was in
its scan stages (``dispatch`` or ``ingest``, by the activity's midpoint),
over the window's dispatches (``kta_dispatch_seconds``). Finalize's copy
of the state and the backend's construction between audits are left out."""

#: The drive loop's stages in which the device runs the fold's work: its
#: launches are enqueued in ``dispatch`` and may still run in ``ingest``.
SCAN_STAGES = ("dispatch", "ingest")


def read(layer: dict, config: dict):
    dev = layer["device"]
    n = layer["counters"].get("kta_dispatch_seconds:count", 0.0)
    if not dev or n <= 0:
        return None
    seconds = sum(dev["stage_device_s"].get(s, 0.0) for s in SCAN_STAGES)
    if seconds <= 0:
        return None
    return seconds * 1e3 / n
