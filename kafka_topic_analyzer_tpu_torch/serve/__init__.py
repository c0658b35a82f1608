"""Follow-mode service layer: the long-running analyzer (port of the
reference's ``serve`` package; DESIGN.md §18).

The batch CLI scans earliest→latest and exits; this package keeps the
scan alive at the head and turns the process into a service:

- ``serve.follow``  — the tail loop: re-poll watermarks, fold new records
  incrementally through the existing engine (superbatch, parallel
  ingest, and the sharded mesh all compose unchanged), checkpoint on an
  interval, stop cleanly on SIGINT/SIGTERM;
- ``serve.windows`` — the time-windowed folds: a ring of associatively
  mergeable window states (per-window record rate, per-partition
  cardinality, size distribution) answering "what changed in the last
  5 minutes", which no cumulative fold can;
- ``serve.state``   — the lock-consistent report snapshot the HTTP layer
  serves at ``/report.json``: the drive loop PUBLISHES pre-serialized
  documents, handlers only ever READ the latest — a slow scrape can
  never stall ingest.
- ``serve.push``    — the Server-Sent-Events fan-out of every publish
  (``/events`` under ``--sse``);
- ``serve.signals`` — the SIGINT/SIGTERM graceful-stop wiring.
"""

from kafka_topic_analyzer_tpu_torch.serve.follow import FollowService  # noqa: F401
from kafka_topic_analyzer_tpu_torch.serve.state import (  # noqa: F401
    ServiceState,
    active,
    set_active,
)
