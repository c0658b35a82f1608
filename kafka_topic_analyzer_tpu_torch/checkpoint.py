"""Scan snapshots: resumable long scans (port of the reference's
``checkpoint.py``, in numpy only).

The analyzer state is a small set of associatively merged arrays, so a
snapshot is

    (config fingerprint, per-partition next offsets, state arrays)

written atomically.  Resuming replays nothing: the saved state already
folds every record below the saved offsets, and the source continues from
them.  Works because updates are deterministic folds and batches respect
per-partition offset order (records.py contract).

Format — the seam between the two packages, so it is the reference's to
the byte: one ``.npz`` per snapshot (atomic rename) holding a ``__meta__``
JSON string plus one array per state leaf keyed ``"state." + <leaf
path>`` (``state.metrics.per_partition``, ``state.alive.words`` as
uint32, ...).  A state here is the dict of numpy leaves that
`models.state.state_to_numpy` gives (leaf path → array), so a snapshot
written by either package resumes in the other.

Two layouts, the reference's: the single-device one, and a mesh
backend's stacked one (record-parallel leaves ``[D·S, ...]``, the bitmap
``[D, W]``; parallel/sharded.py).  A snapshot without the alive bitmap is
stored canonical — its rows folded into the single-device layout through
each leaf's merge law (`_canonicalize`) — and resumes under any mesh
shape, spread back as (canonical, identity, ...) rows (`_distribute`).
An alive-key snapshot keeps the writer's stacked layout and resumes only
under the writer's mesh: its fingerprint names the mesh, and a mismatch
names the writer's ``--mesh``.

A scan of several controllers (``--distributed``) writes one file per
process, ``scan_snapshot.p<pid>of<nproc>.npz``, with that process's data
rows alone (``[L·S, ...]`` leaves, the bitmap ``[L, W]``; canonical when
mesh-free) and its partitions' offsets: the ``scope`` argument, ``(pid,
nproc, local_rows)``.  Data rows fold apart, so each process resumes from
its own file, and one without a file rescans its rows from zero, which is
still exact.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.models.state import identity_leaves, merge_rows

SNAPSHOT_NAME = "scan_snapshot.npz"

#: A state as the snapshot holds it: leaf path → host array.
Leaves = Dict[str, np.ndarray]


class StaleLeaseEpochError(ValueError):
    """A snapshot save or load was FENCED: the caller's lease epoch is
    older than the epoch already stamped on disk.

    The zombie-writer guard of the reference's fleet leases: an instance
    that lost its topic lease while paused mid-pass must never land a
    checkpoint over its successor's, and must never resume FROM a
    successor's checkpoint as if it still owned the topic."""


#: Config fields that change neither state shapes nor fold semantics —
#: pure execution strategy, safe to flip across a resume (the pallas and
#: plain counter paths are bit-identical; wire v4 and v5 fold to
#: byte-identical state, so a v4 snapshot resumes under v5 and vice versa;
#: compacted and uncompacted alive-pair folds are byte-identical).
#: Excluding wire_format (and alive_compaction) also keeps pre-v5
#: snapshots' fingerprints valid unchanged.
_EXECUTION_ONLY_FIELDS = (
    "use_pallas_counters",
    "wire_format",
    "alive_compaction",
)


def _fingerprint_at(
    config: AnalyzerConfig,
    topic: str,
    version: int,
    mesh_free: bool = False,
    mesh_shape: "Optional[Tuple[int, int]]" = None,
) -> str:
    """The stamp of ``config`` (with ``mesh_shape`` in place of its own,
    when given: a rejection message probes the stamps of other meshes)."""
    fields = dataclasses.asdict(config)
    if mesh_shape is not None:
        fields["mesh_shape"] = tuple(mesh_shape)
    for k in _EXECUTION_ONLY_FIELDS:
        fields.pop(k, None)
    if mesh_free:
        # Mesh-free snapshots store the canonical (single-device-layout)
        # state, which every mesh can adopt — so the mesh shape is pure
        # execution strategy for them and must not pin the fingerprint.
        fields.pop("mesh_shape", None)
    if config.enable_quantiles:
        # The DDSketch bucket rule changed once (float32 log → the shared
        # integer edge table): borderline sizes can land one bucket over
        # against the old rule, so a snapshot of the old rule must not
        # merge with new-rule buckets.  Quantile-free configs keep their
        # earlier fingerprints (no bucket state to skew).
        fields["ddsketch_bucket_rule"] = "edges-v1"
    payload = json.dumps(
        {"topic": topic, "state_version": version, **fields},
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _space_shards(config: AnalyzerConfig) -> int:
    return int(tuple(config.mesh_shape)[1])


def mesh_free_snapshots(config: AnalyzerConfig) -> bool:
    """True when this config's snapshots are stored in the mesh-free
    single-device layout and may resume under any mesh shape (and any
    ``--ingest-workers`` or ``--dispatch-depth``, which never enter the
    fingerprint).

    Every analyzer fold but one is associative AND commutative across
    device rows; the exception is the alive-key bitmap: last-writer-wins
    bit clears only resolve against the row that set the bit, so
    alive-key scans keep the mesh-pinned fingerprint."""
    return not config.count_alive_keys


def config_fingerprint(config: AnalyzerConfig, topic: str) -> str:
    """Snapshot compatibility key (the one new snapshots are stamped with):
    anything that changes state shapes or fold semantics participates.

    state_version: 2 for single-space-shard layouts, 3 where space shards
    add record-parallel rows, 4 for the mesh-free layout of configs
    without the alive bitmap (`mesh_free_snapshots`), whose fingerprint
    leaves the mesh shape out.  The reference's numbering, kept so both
    packages stamp the same hex string."""
    if mesh_free_snapshots(config):
        return _fingerprint_at(config, topic, 4, mesh_free=True)
    version = 2 if _space_shards(config) == 1 else 3
    return _fingerprint_at(config, topic, version)


def acceptable_fingerprints(config: AnalyzerConfig, topic: str) -> "set[str]":
    """All fingerprints a loader should accept for this config: the
    canonical one, plus the compatible legacy stamps — the v3 variant for
    single-space-shard configs (identical layout under both labels), and
    for mesh-free configs the mesh-pinned stamp of the same mesh."""
    out = {config_fingerprint(config, topic)}
    if mesh_free_snapshots(config):
        out.add(_fingerprint_at(config, topic, 2 if _space_shards(config) == 1 else 3))
    if _space_shards(config) == 1:
        out.add(_fingerprint_at(config, topic, 3))
    return out


def _stacked(config: AnalyzerConfig) -> bool:
    """Whether ``config``'s backend keeps the stacked mesh layout."""
    return tuple(config.mesh_shape) != (1, 1)


def state_template(
    config: AnalyzerConfig, stacked: "bool | None" = None,
    rows: "int | None" = None,
) -> "Dict[str, Tuple[tuple, np.dtype]]":
    """Shape and dtype of every state leaf of ``config`` in its backend's
    layout (``stacked``: the mesh layout, by default for any mesh but
    (1, 1)), without building the state: the single-device leaves
    `models.state.state_to_numpy` gives, or their stacked forms
    (`parallel.sharded.ShardedTorchBackend.get_state`) over ``rows`` data
    rows (default: all of the mesh's; one process's under a scope)."""
    if stacked is None:
        stacked = _stacked(config)
    if stacked:
        d, s = tuple(config.mesh_shape)
        d = d if rows is None else rows
        out = {
            name: ((d * s,) + shape, dtype)
            for name, (shape, dtype) in state_template(config, False).items()
        }
        if config.count_alive_keys:
            out["alive.words"] = (
                (d, 1 << max(config.alive_bitmap_bits - 5, 0)),
                np.dtype(np.uint32),
            )
        return out
    p = config.num_partitions
    i64 = np.dtype(np.int64)
    out: "Dict[str, Tuple[tuple, np.dtype]]" = {
        "metrics.per_partition": ((p, 7), i64),
        "metrics.earliest_s": ((p,), i64),
        "metrics.latest_s": ((p,), i64),
        "metrics.smallest": ((p,), i64),
        "metrics.largest": ((p,), i64),
        "metrics.overall_size": ((), i64),
        "metrics.overall_count": ((), i64),
    }
    if config.count_alive_keys:
        words = 1 << max(config.alive_bitmap_bits - 5, 0)
        out["alive.words"] = ((words,), np.dtype(np.uint32))
    if config.enable_hll:
        rows = p if config.distinct_keys_per_partition else 1
        out["hll.regs"] = ((rows, config.hll_m), np.dtype(np.int32))
    if config.enable_quantiles:
        rows = p if config.quantiles_per_partition else 1
        # Zero bucket + log buckets + overflow (ops.ddsketch).
        out["quantiles.counts"] = ((rows, config.quantile_buckets + 2), i64)
    return out


def _canonicalize(state: Leaves, config: AnalyzerConfig) -> Leaves:
    """What a snapshot of ``state`` stores: a mesh-free config's stacked
    state folded into the canonical single-device layout through each
    leaf's merge law (`models.state.merge_rows`); anything else as it
    is."""
    if mesh_free_snapshots(config) and state["metrics.per_partition"].ndim == 3:
        return merge_rows(state)
    return state


def _distribute(canonical: Leaves, config: AnalyzerConfig,
                rows: "int | None" = None) -> Leaves:
    """A canonical snapshot spread over ``config``'s stacked layout (of
    ``rows`` data rows, `state_template`): row 0 holds the canonical fold,
    every other row its leaf's merge identity, so the mesh's finalize
    reduces to exactly the canonical values, and records folded after the
    resume land in whichever row their partition now maps to (every fold
    but the bitmap's is associative and commutative across rows)."""
    identity = identity_leaves(config)
    out = {}
    for name, (shape, _) in state_template(config, rows=rows).items():
        spread = np.broadcast_to(identity[name], shape).copy()
        spread[0] = canonical[name]
        out[name] = spread
    return out


def _snapshot_path(directory: str, scope=None) -> str:
    """The one snapshot file of a single-controller scan, or one process's
    file under several (``scope``: ``(pid, nproc, local_rows)``)."""
    if scope is None:
        return os.path.join(directory, SNAPSHOT_NAME)
    pid, nproc, _rows = scope
    return os.path.join(directory, f"scan_snapshot.p{pid}of{nproc}.npz")


def save_snapshot(
    directory: str,
    topic: str,
    config: AnalyzerConfig,
    state: Leaves,
    next_offsets: Dict[int, int],
    records_seen: int,
    init_now_s: int,
    scope=None,
    degraded: "Optional[Dict[int, str]]" = None,
    corrupt: "Optional[list]" = None,
    lease_epoch: "Optional[int]" = None,
    lost: "Optional[list]" = None,
    partition_meta: "Optional[Dict[int, dict]]" = None,
) -> str:
    """Atomically write the snapshot of ``state`` (leaf path → host
    array); returns its path.

    ``scope``: None, or ``(pid, nproc, local_rows)`` under several
    controllers; ``state`` is then that process's rows
    (`parallel.sharded.ShardedTorchBackend.get_state_local`).

    ``degraded``: partition -> reason for partitions the scan dropped.
    Informational only — resume reads ``next_offsets``, which already stop
    at each degraded partition's last folded record.

    ``corrupt``: the span list of poisoned frames the scan skipped or
    quarantined (`KafkaWireSource.corruption_spans`).  A ``--resume``
    seeds the source with it (`load_corrupt_spans`) so re-walking an
    already skipped span neither re-counts nor double-quarantines it.

    ``lost``: the span list of offset ranges the log took away from the
    scan (`KafkaWireSource.lost_spans`); a ``--resume`` seeds the source
    with it so the logical scan's report still names the loss.

    ``partition_meta``: {partition: {leader_epoch, log_start_offset}}
    (`KafkaWireSource.partition_meta`); resume validates the saved cursor
    against the live log with it (`KafkaWireSource.validate_resume`).

    ``lease_epoch``: the writer's topic-ownership lease epoch; the save is
    fenced (`StaleLeaseEpochError`) when the on-disk snapshot carries a
    newer one.  None skips the check and stamps nothing."""
    os.makedirs(directory, exist_ok=True)
    if lease_epoch is not None:
        try:
            prev = snapshot_info(directory, scope)
        except Exception:
            prev = None  # an unreadable snapshot cannot outrank us
        prev_epoch = int((prev or {}).get("lease_epoch", 0))
        if prev_epoch > int(lease_epoch):
            raise StaleLeaseEpochError(
                f"STALE-LEASE-EPOCH: refusing to save snapshot for topic "
                f"{topic!r}: the on-disk snapshot carries lease epoch "
                f"{prev_epoch}, this writer holds epoch {int(lease_epoch)} "
                "— this instance was fenced (its topic lease expired and "
                "a successor took over).  Do not retry: the successor's "
                "checkpoint is the live one"
            )
    flat = {
        "state." + k: np.asarray(v)
        for k, v in _canonicalize(state, config).items()
    }
    meta = {
        "fingerprint": config_fingerprint(config, topic),
        "topic": topic,
        "next_offsets": {str(k): int(v) for k, v in next_offsets.items()},
        "records_seen": int(records_seen),
        "init_now_s": int(init_now_s),
    }
    if degraded:
        meta["degraded"] = {str(k): str(v) for k, v in degraded.items()}
    if corrupt:
        meta["corrupt_spans"] = list(corrupt)
    if lost:
        meta["lost_spans"] = list(lost)
    if partition_meta:
        meta["partition_meta"] = {
            str(k): {
                "leader_epoch": int(v.get("leader_epoch", -1)),
                "log_start_offset": int(v.get("log_start_offset", -1)),
            }
            for k, v in partition_meta.items()
        }
    if lease_epoch is not None:
        meta["lease_epoch"] = int(lease_epoch)
    if scope is not None:
        meta["process"] = [int(scope[0]), int(scope[1])]
        meta["local_rows"] = [int(r) for r in scope[2]]
    path = _snapshot_path(directory, scope)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _fingerprint_mismatch_message(
    path: str, meta: dict, config: AnalyzerConfig, topic: str
) -> str:
    """A rejection message that names the cause when it can: for an
    alive-key scan, probe whether the snapshot's stamp matches this config
    under another mesh shape and, when it does, say which mesh wrote it
    and what a resume may change."""
    base = (
        f"snapshot at {path} was taken with a different topic/config "
        "(fingerprint mismatch)"
    )
    if not config.count_alive_keys:
        return base + " — delete it or match the original flags"
    stamp = meta.get("fingerprint")
    for d in range(1, 65):
        for s in (1, 2, 4, 8):
            shape = (d, s)
            if shape == tuple(config.mesh_shape):
                continue
            # s == 1 writers stamp version 2, older ones version 3 (see
            # acceptable_fingerprints): probe both.
            versions = (2, 3) if s == 1 else (3,)
            if any(
                _fingerprint_at(config, topic, v, mesh_shape=shape) == stamp
                for v in versions
            ):
                return (
                    f"snapshot at {path} is MESH-PINNED and was written by "
                    f"a mesh {shape[0]}x{shape[1]} scan: this scan counts "
                    "alive keys (-c/--count-alive-keys), and alive-key "
                    "snapshots only resume under the ORIGINAL mesh shape "
                    "(last-writer-wins bit clears must land on the data "
                    "row that set the bit — DESIGN.md §14).  Resume with "
                    f"--mesh {shape[0]},{shape[1]} (ingest workers, "
                    "superbatch, dispatch depth, wire format and "
                    "alive-compaction may all change freely), or delete "
                    "the snapshot to rescan under "
                    f"--mesh {config.mesh_shape[0]},{config.mesh_shape[1]}"
                )
    return (
        base
        + " — this scan counts alive keys (-c/--count-alive-keys), whose "
        "snapshots additionally pin the mesh shape; delete the snapshot "
        "or match the original flags"
    )


def load_snapshot(
    directory: str,
    topic: str,
    config: AnalyzerConfig,
    lease_epoch: "Optional[int]" = None,
    scope=None,
) -> "Optional[Tuple[Leaves, Dict[int, int], int, int]]":
    """Load (state leaves, next_offsets, records_seen, init_now_s), or
    None if no snapshot exists.  An incompatible snapshot (different
    config or topic) raises — silently restarting would double-count.

    Every leaf must have the shape and dtype `state_template` gives for
    ``config`` — or, for a mesh-free config under a mesh, the canonical
    single-device ones, spread over the mesh (`_distribute`).
    ``lease_epoch``: a snapshot stamped with a newer epoch was written by
    a successor, and resuming it raises `StaleLeaseEpochError`.  With a
    ``scope`` (`save_snapshot`) the file and the state are that process's,
    and a file of another process layout raises."""
    path = _snapshot_path(directory, scope)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        if meta["fingerprint"] not in acceptable_fingerprints(config, topic):
            raise ValueError(
                _fingerprint_mismatch_message(path, meta, config, topic)
            )
        if (
            lease_epoch is not None
            and int(meta.get("lease_epoch", 0)) > int(lease_epoch)
        ):
            raise StaleLeaseEpochError(
                f"STALE-LEASE-EPOCH: refusing to resume topic {topic!r} "
                f"from {path}: the snapshot was written under lease epoch "
                f"{int(meta['lease_epoch'])}, this loader holds epoch "
                f"{int(lease_epoch)} — this instance was fenced (a "
                "successor owns the topic).  Re-acquire the lease to get "
                "a current epoch before resuming"
            )
        rows = None
        if scope is not None:
            pid, nproc, rows = scope
            if meta.get("process") != [pid, nproc] or meta.get(
                "local_rows"
            ) != [int(r) for r in rows]:
                raise ValueError(
                    f"snapshot at {path} belongs to a different process "
                    "layout (process/data-row mismatch) — delete it or "
                    "rerun with the original mesh and process count"
                )
            rows = len(rows)
        template = state_template(config, rows=rows)
        spread = (
            mesh_free_snapshots(config)
            and _stacked(config)
            and z["state.metrics.per_partition"].ndim == 2
        )
        if spread:
            template = state_template(config, stacked=False)
        state: Leaves = {}
        for name, (shape, dtype) in template.items():
            key = "state." + name
            arr = z[key]
            if arr.shape != tuple(shape) or arr.dtype != dtype:
                raise ValueError(f"snapshot leaf {key} has shape {arr.shape}")
            state[name] = arr
    if spread:
        state = _distribute(state, config, rows=rows)
    offsets = {int(k): int(v) for k, v in meta["next_offsets"].items()}
    return state, offsets, int(meta["records_seen"]), int(meta["init_now_s"])


def snapshot_info(directory: str, scope=None) -> "Optional[dict]":
    """Snapshot METADATA (fingerprint, topic, per-partition next offsets,
    records_seen, degraded/corrupt annotations) without loading the state
    arrays — or None when no snapshot exists (``scope``: one process's
    file, `save_snapshot`)."""
    path = _snapshot_path(directory, scope)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__meta__"]))


HISTORY_DIR_NAME = "_kta_history"


def history_dir(directory: str) -> str:
    """Where the disk-backed telemetry history (obs/history.py,
    ``--history-bytes``) lives: a reserved subdirectory of the
    ``--snapshot-dir``, so a SIGTERM→restart that resumes the state from
    its checkpoint resumes the telemetry series from the same place —
    one directory to move, back up, or delete."""
    return os.path.join(directory, HISTORY_DIR_NAME)


def load_corrupt_spans(directory: str, scope=None) -> list:
    """The ``corrupt_spans`` metadata of a snapshot, or [] when the
    snapshot (or the list) is absent."""
    return list((snapshot_info(directory, scope) or {}).get("corrupt_spans", []))


def load_lost_spans(directory: str, scope=None) -> list:
    """The ``lost_spans`` metadata of a snapshot, or [] when the snapshot
    (or the list) is absent."""
    return list((snapshot_info(directory, scope) or {}).get("lost_spans", []))


def load_partition_meta(directory: str, scope=None) -> "Dict[int, dict]":
    """The ``partition_meta`` fencing map of a snapshot ({partition:
    {leader_epoch, log_start_offset}}), or {} when the snapshot (or the
    map) is absent."""
    meta = snapshot_info(directory, scope) or {}
    return {
        int(k): {
            "leader_epoch": int(v.get("leader_epoch", -1)),
            "log_start_offset": int(v.get("log_start_offset", -1)),
        }
        for k, v in meta.get("partition_meta", {}).items()
    }


def topic_snapshot_dir(directory: str, topic: str) -> str:
    """Fleet checkpoint namespacing: each topic's snapshots live in their
    own subdirectory of the fleet's ``--snapshot-dir`` (Kafka topic names
    are ``[a-zA-Z0-9._-]``, so the name is a safe path segment).  A solo
    scan pointed at the subdirectory resumes the fleet's checkpoint and
    the other way round."""
    return os.path.join(directory, topic)


def list_topic_snapshots(directory: str) -> "dict[str, dict]":
    """topic -> snapshot metadata for every per-topic snapshot under a
    fleet snapshot directory (`snapshot_info` of each subdirectory).  An
    unreadable snapshot (a fleet killed mid-write) is skipped with a
    warning; that topic's own resume reports the error."""
    import logging

    out: "dict[str, dict]" = {}
    if not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        sub = os.path.join(directory, name)
        if not os.path.isdir(sub):
            continue
        try:
            info = snapshot_info(sub)
        except Exception:
            logging.getLogger(__name__).warning(
                "snapshot inventory: unreadable snapshot under %r "
                "(skipped)", sub, exc_info=True,
            )
            continue
        if info is not None:
            out[name] = info
    return out
