"""Service: the 95th percentile (nearest rank) over the window's SSE frames
of the arrival at the client minus the document's publish time
(``report_ts``, both wall clock), in milliseconds."""

from benchmark.probes import nearest_rank


def read(layer: dict, config: dict):
    gaps = [(wall - data["report_ts"]) * 1e3 for wall, data in layer["frames"]
            if "report_ts" in data]
    return nearest_rank(gaps, 0.95) if gaps else None
