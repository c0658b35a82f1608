"""The instruments the port books that the reference's catalog lacks: what
the port measures inside its own layers (worker and drive-loop CPU, the
fetch rounds' wait, finalize's phases, the device-resident bytes and
their high-water mark, each fold's device span, the fleet's admission
waits, passes and released backends, the exact alive set's entries,
grows and switches to the dense bitmap, their seconds, the bytes a grow
stages through the host, the pairs a dense bitmap takes, the seconds and
bytes of each codec's decompression, and the seconds of the per-frame
chain).
Name → (kind, label names)."""

PORT_ONLY = {
    "kta_stage_cpu_seconds_total": ("counter", ("stage",)),
    "kta_ingest_worker_cpu_seconds_total": ("counter", ("worker",)),
    "kta_ingest_round_wait_seconds_total": ("counter", ()),
    "kta_fold_device_seconds_total": ("counter", ()),
    "kta_finalize_phase_seconds_total": ("counter", ("phase",)),
    "kta_device_resident_bytes_total": ("counter", ("owner",)),
    "kta_device_resident_bytes_max": ("gauge", ()),
    "kta_fleet_admission_wait_seconds_total": ("counter", ()),
    "kta_fleet_pass_seconds_total": ("counter", ()),
    "kta_fleet_backends_released_total": ("counter", ()),
    "kta_alive_set_entries": ("gauge", ()),
    "kta_alive_set_grows_total": ("counter", ()),
    "kta_alive_dense_conversions_total": ("counter", ()),
    "kta_alive_grow_seconds_total": ("counter", ()),
    "kta_alive_grow_staged_bytes_total": ("counter", ()),
    "kta_alive_switch_seconds_total": ("counter", ()),
    "kta_alive_dense_pairs_total": ("counter", ()),
    "kta_decompress_seconds_total": ("counter", ("codec",)),
    "kta_decompress_in_bytes_total": ("counter", ("codec",)),
    "kta_decompress_out_bytes_total": ("counter", ("codec",)),
    "kta_frame_fallback_seconds_total": ("counter", ()),
}


#: Instruments of the reference's catalog whose help the port words
#: otherwise, because the port times what the reference leaves untimed:
#: name → what the port's help names and the reference's does not.
PORT_HELP = {
    "kta_decode_seconds_total": "kta_frame_fallback_seconds_total",
}


def drop_port_only(exposition: bytes) -> bytes:
    """A Prometheus text exposition without the lines of the `PORT_ONLY`
    families and the help lines of the `PORT_HELP` ones: what the port's
    exporter and the reference's serve alike for the same registry."""

    def family(line: bytes) -> bytes:
        if line.startswith((b"# HELP ", b"# TYPE ")):
            return line.split(b" ")[2]
        return line.split(b"{")[0].split(b" ")[0]

    names = {name.encode() for name in PORT_ONLY}
    helps = {name.encode() for name in PORT_HELP}
    return b"".join(line for line in exposition.splitlines(keepends=True)
                    if family(line) not in names
                    and not (line.startswith(b"# HELP ") and family(line) in helps))
