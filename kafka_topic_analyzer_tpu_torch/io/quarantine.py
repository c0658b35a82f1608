"""Poison-frame quarantine: spool corrupt raw frames with a JSON sidecar
(port of the reference's ``io/quarantine.py``, unchanged).

When the scan runs with ``--on-corruption=quarantine``, every frame that
fails decode *deterministically* (the wire layer re-fetched it once and got
byte-identical garbage back) is written here before being skipped — the
same evidence-preservation discipline large-scale training data loaders
apply to poison samples: the pipeline finishes, and the bad bytes survive
for offline analysis instead of evaporating with the process.

Layout: one ``<topic>.p<partition>.o<anchor>.frame.bin`` (the raw frame
bytes, exactly as fetched) plus a ``.json`` sidecar describing it:

    {"topic", "partition", "anchor", "base_offset", "offset_start",
     "offset_end", "classification", "crc_expected", "crc_actual",
     "length", "sha256", "error"}

Filenames are keyed by the frame's *anchor* (the scan position at which it
was hit), which is stable across runs — so a ``--resume`` that re-walks an
already-quarantined span is a no-op here (`spool` returns None when the
sidecar already exists) and never double-spools.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Optional, Tuple


def _safe_topic(topic: str) -> str:
    """Kafka topic names allow [a-zA-Z0-9._-] only, but quarantine paths
    must stay safe even for a hostile broker's metadata."""
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in topic)


class QuarantineStore:
    """Append-only spool of poisoned frames under one directory."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _paths(self, topic: str, partition: int, anchor: int) -> "Tuple[str, str]":
        stem = os.path.join(
            self.directory, f"{_safe_topic(topic)}.p{partition}.o{anchor}"
        )
        return stem + ".frame.bin", stem + ".json"

    def spool(
        self,
        *,
        topic: str,
        partition: int,
        anchor: int,
        raw: bytes,
        classification: str,
        base_offset: int = -1,
        offset_start: int = -1,
        offset_end: int = -1,
        crc_expected: Optional[int] = None,
        crc_actual: Optional[int] = None,
        error: str = "",
    ) -> Optional[str]:
        """Write the frame + sidecar; returns the sidecar path, or None
        when this span was already quarantined (resume idempotence).  The
        sidecar is renamed into place LAST, so a sidecar's existence
        guarantees its .bin is complete."""
        bin_path, sidecar = self._paths(topic, partition, anchor)
        if os.path.exists(sidecar):
            return None
        meta = {
            "topic": topic,
            "partition": partition,
            "anchor": anchor,
            "base_offset": base_offset,
            "offset_start": offset_start,
            "offset_end": offset_end,
            "classification": classification,
            "crc_expected": crc_expected,
            "crc_actual": crc_actual,
            "length": len(raw),
            "sha256": hashlib.sha256(raw).hexdigest(),
            "error": error,
        }
        for path, payload in (
            (bin_path, raw),
            (sidecar, json.dumps(meta, sort_keys=True).encode() + b"\n"),
        ):
            fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(payload)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return sidecar

    def entries(self) -> "list[str]":
        """Sidecar paths of every quarantined frame, sorted."""
        return sorted(
            os.path.join(self.directory, name)
            for name in os.listdir(self.directory)
            if name.endswith(".json")
        )

    @staticmethod
    def load(sidecar_path: str) -> "Tuple[dict, bytes]":
        """Round-trip one quarantined frame: (sidecar meta, raw bytes).
        Raises ValueError when the stored bytes do not match the sidecar's
        length/sha256 (a quarantine spool must itself be trustworthy)."""
        with open(sidecar_path, "r", encoding="utf-8") as f:
            meta = json.load(f)
        bin_path = sidecar_path[: -len(".json")] + ".frame.bin"
        with open(bin_path, "rb") as f:
            raw = f.read()
        if len(raw) != meta["length"] or (
            hashlib.sha256(raw).hexdigest() != meta["sha256"]
        ):
            raise ValueError(
                f"quarantined frame {bin_path} does not match its sidecar"
            )
        return meta, raw
