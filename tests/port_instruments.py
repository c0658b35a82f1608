"""The instruments the port books that the reference's catalog lacks: what
the port measures inside its own layers (worker and drive-loop CPU, the
fetch rounds' wait, finalize's phases, the device-resident bytes and
their high-water mark, each fold's device span, the fleet's admission
waits, passes and released backends, the exact alive set's entries,
grows and switches to the dense bitmap, their seconds, the bytes a grow
stages through the host, and the pairs a dense bitmap takes).
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
}


def drop_port_only(exposition: bytes) -> bytes:
    """A Prometheus text exposition without the lines of the `PORT_ONLY`
    families: what the reference's exporter serves for the same
    registry."""

    def family(line: bytes) -> bytes:
        if line.startswith((b"# HELP ", b"# TYPE ")):
            return line.split(b" ")[2]
        return line.split(b"{")[0].split(b" ")[0]

    names = {name.encode() for name in PORT_ONLY}
    return b"".join(line for line in exposition.splitlines(keepends=True)
                    if family(line) not in names)
