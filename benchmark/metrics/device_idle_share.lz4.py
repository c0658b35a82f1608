"""Device: one minus the union of the device's activity over the traced
window, as ``device_idle_share.scan`` reads it, in the LZ4 cell."""

from benchmark.run import load_reader

read = load_reader("device_idle_share.scan")
