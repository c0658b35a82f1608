"""Device: the bytes an audit's backend keeps on the device, as
``device_resident_bytes.scan`` reads them (its construction's bytes and
every grow's and the switch's added bytes, over the window's finalizes):
in the published-keys cell the dense bitmap's 512 MiB and the sketches."""

from benchmark.run import load_reader

read = load_reader("device_resident_bytes.scan")
