"""Kernels: ``counters_merge``'s share of its roofline, in percent: the
least time the bytes it needs take at the card's peak bandwidth, over its
mean device time per launch in the traced window."""

from benchmark.roofline import H100_HBM_BYTES_PER_S, counters_merge_bytes


def read(layer: dict, config: dict):
    dev = layer["device"]
    if not dev:
        return None
    runs = [(s, n) for name, (s, n) in dev["ops"].items() if "counters_merge_kernel" in name]
    seconds = sum(s for s, _ in runs)
    launches = sum(n for _, n in runs)
    if launches == 0 or seconds <= 0:
        return None
    least = counters_merge_bytes(config["topic"]["partitions"]) / H100_HBM_BYTES_PER_S
    return 100.0 * least / (seconds / launches)
