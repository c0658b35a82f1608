"""Device: one minus the union of the device's activity (kernels, copies,
memsets in the ``torch.profiler`` trace) over the traced window of fleet
audits."""


def read(layer: dict, config: dict):
    dev = layer["device"]
    if not dev or dev["window_s"] <= 0 or not dev["ops"]:
        return None
    return 1.0 - dev["busy_s"] / dev["window_s"]
