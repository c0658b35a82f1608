"""Cluster topic discovery: metadata → the fleet's topic list (port of the
reference's ``fleet/discovery.py``).

One all-topics Metadata request (`io.kafka_wire.discover_cluster_topics`)
lists what a fleet could cover; this module filters it:

- include globs (``-t`` under ``--fleet``; comma-separated fnmatch
  patterns, default ``*``) select topics by name;
- exclude globs (``--fleet-exclude``) drop matches again, after the
  includes;
- internal topics (``__consumer_offsets`` and the like) are dropped
  unless ``--fleet-internal`` asks for them: the broker's ``is_internal``
  flag and the ``__`` name prefix both count.

A topic whose metadata carries an error (one being deleted) is skipped
with a log line.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import logging
from typing import Iterable, List, Optional, Sequence

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DiscoveredTopic:
    """One discovery hit: what the scheduler needs to seed a scan."""

    name: str
    #: Partition count from the metadata response (the scheduler's seed
    #: weight).
    partitions: int
    #: Broker-flagged or ``__``-prefixed system topic.
    internal: bool = False


def parse_globs(spec: "Optional[str]") -> "List[str]":
    """Comma-separated glob list → pattern list ('' / None → none)."""
    if not spec:
        return []
    return [g.strip() for g in spec.split(",") if g.strip()]


def is_internal_name(name: str) -> bool:
    """``__consumer_offsets``-style system-topic naming (the prefix
    convention predates the metadata flag)."""
    return name.startswith("__")


def filter_topics(
    topics: "Iterable[DiscoveredTopic]",
    include: "Sequence[str]" = ("*",),
    exclude: "Sequence[str]" = (),
    include_internal: bool = False,
) -> "List[DiscoveredTopic]":
    """Apply the include/exclude globs and the internal exclusion; sorted
    by name, so every run and every re-discovery sees one order."""
    include = list(include) or ["*"]
    out = []
    for t in topics:
        if t.internal and not include_internal:
            continue
        if not any(fnmatch.fnmatchcase(t.name, g) for g in include):
            continue
        if any(fnmatch.fnmatchcase(t.name, g) for g in exclude):
            continue
        out.append(t)
    return sorted(out, key=lambda t: t.name)


def discover_topics(
    bootstrap_servers: str,
    include: "Sequence[str]" = ("*",),
    exclude: "Sequence[str]" = (),
    include_internal: bool = False,
    timeout_s: float = 10.0,
) -> "List[DiscoveredTopic]":
    """All-topics metadata → the filtered, sorted `DiscoveredTopic` list.
    An empty list is a valid answer; the CLI decides whether it is an
    error."""
    from kafka_topic_analyzer_tpu_torch.io.kafka_wire import (
        discover_cluster_topics,
    )

    found: "List[DiscoveredTopic]" = []
    for md in discover_cluster_topics(bootstrap_servers, timeout_s=timeout_s):
        if md.error:
            log.warning(
                "discovery: skipping topic %r (metadata error %d)",
                md.name, md.error,
            )
            continue
        found.append(
            DiscoveredTopic(
                name=md.name,
                partitions=len(md.partitions),
                internal=bool(md.is_internal) or is_internal_name(md.name),
            )
        )
    return filter_topics(found, include, exclude, include_internal)
