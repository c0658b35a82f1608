"""Kernels: ``bitmap_pairs``' share of its roofline, in percent: the least
time the bytes of a launch of the mean pair count take at the card's peak
bandwidth, over its mean device time per launch in the traced window.  The
pairs are the program's ``kta_alive_dense_pairs_total`` (every pair a
dense bitmap took, a switch's loaded slots included), the launches the
trace's ``bitmap_pairs_kernel``."""

from benchmark.reference.report import features
from benchmark.roofline import H100_HBM_BYTES_PER_S
from benchmark.roofline_dense import bitmap_pairs_bytes


def read(layer: dict, config: dict):
    dev = layer["device"]
    pairs = layer["counters"].get("kta_alive_dense_pairs_total")
    if not dev or not pairs:
        return None
    runs = [(s, n) for name, (s, n) in dev["ops"].items() if "bitmap_pairs_kernel" in name]
    seconds = sum(s for s, _ in runs)
    launches = sum(n for _, n in runs)
    if launches == 0 or seconds <= 0:
        return None
    bits = features(config["argv"])["alive_bits"]
    least = bitmap_pairs_bytes(pairs / launches, bits) / H100_HBM_BYTES_PER_S
    return 100.0 * least / (seconds / launches)
