"""Per-topic ownership leases: the fleet's arbitration layer (port of the
reference's ``fleet/lease.py``; same record JSON, same file and object
names, so a lease written by either package is read by the other).

Two analyzer instances pointed at one cluster split its topics instead of
scanning each twice.  A lease record, kept in a store the system already
trusts (the checkpoint directory, or the remote segment store), carries

- an owner (the analyzer instance id, or None once released),
- an epoch that grows on every ownership change and is never reset
  (released records keep theirs, so a zombie can never reacquire at
  epoch 1), and
- an expiry (the owner's clock + TTL, renewed at poll boundaries).

The epoch is the fencing token: `checkpoint.save_snapshot` and
`load_snapshot` stamp and check it, so an instance that lost its lease
while paused mid-pass has its late checkpoint refused with
`checkpoint.StaleLeaseEpochError`.

Two stores, one contract (``read`` → (lease, token), ``write`` → new
token, or None on a lost compare-and-swap):

- `FileLeaseStore`: JSON records under ``_kta_leases/`` of the checkpoint
  directory, written tmp-file → ``os.replace`` inside a short O_EXCL lock
  (a lock older than its hold bound is broken).  The token is the record
  body the caller read; inside the lock the record is read again and the
  write refused unless it still matches, so two instances that both read
  "absent" cannot both be granted epoch 1.  A read-back after the replace
  catches a racer that bypassed the lock.
- `ObjectLeaseStore`: ETag-fenced conditional PUTs through
  `io.objstore.RetryingHttp.put_conditional`.  A PUT retried across a
  transport error may have been applied, so a 412 is resolved by reading
  the record back.

`LeaseManager` runs the acquire / renew / release / fence state machine
on top, with an injectable clock: a store outage during renewal books
``kta_lease_renewals_total{outcome="deferred"}`` and keeps the lease
while it is locally unexpired; the manager fences itself only when it
sees a newer epoch or another owner, or when its local expiry passes
unrenewed.  Every state change of a held lease goes through
``_transition``, which books the ``kta_lease_*`` instruments and emits
the event.
"""

from __future__ import annotations

import dataclasses
import errno
import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from kafka_topic_analyzer_tpu_torch.obs import events as obs_events
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger(__name__)

#: Reserved subdirectory of the checkpoint/snapshot dir holding lease
#: records — same carve-out discipline as checkpoint.HISTORY_DIR_NAME:
#: topic snapshot subdirectories and lease records share a parent, so
#: the name must never collide with a topic directory kta would create.
LEASE_DIR_NAME = "_kta_leases"


@dataclasses.dataclass(frozen=True)
class Lease:
    """One topic's ownership record as persisted in the store."""

    topic: str
    #: Analyzer instance id, or None once released (the record is KEPT —
    #: deleting it would reset the epoch and unfence every zombie).
    owner: "Optional[str]"
    #: Monotonically increasing fencing token: bumped on every ownership
    #: change, never on renewal (a renewal extends expiry, it does not
    #: change who owns the topic).
    epoch: int
    #: Owner's local clock + TTL at the last acquire/renew.
    expires_at: float
    acquired_at: float

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "topic": self.topic,
                "owner": self.owner,
                "epoch": int(self.epoch),
                "expires_at": float(self.expires_at),
                "acquired_at": float(self.acquired_at),
            },
            sort_keys=True,
        ).encode("utf-8")

    @classmethod
    def from_json(cls, data: bytes) -> "Lease":
        d = json.loads(data.decode("utf-8"))
        return cls(
            topic=str(d["topic"]),
            owner=d.get("owner"),
            epoch=int(d["epoch"]),
            expires_at=float(d["expires_at"]),
            acquired_at=float(d.get("acquired_at", 0.0)),
        )


def _safe_name(topic: str) -> str:
    """Filesystem/key-safe record name for a topic (Kafka topic names
    allow dots; path separators cannot appear, but be defensive)."""
    return "".join(
        c if c.isalnum() or c in "._-" else "_" for c in topic
    )


class FileLeaseStore:
    """Lease records as JSON files under ``{directory}/_kta_leases/``.

    The write path is lock → compare → tmp → ``os.replace`` →
    read-back verify.  The token is the raw record body the caller
    read (None = expect absent): inside the O_EXCL lock the current
    record is re-read and a mismatch fails the CAS — this is what
    stops two lock-serialized writers that both read "absent/expired"
    from each being granted the same epoch.  The read-back after the
    replace catches a racer that broke or ignored the lock — either
    way a lost race reports as None, never as a silent double-grant.
    ``verify_hook`` is a test seam invoked between the replace and the
    read-back, where an injected competing write must be detected.
    """

    #: A lock older than this is a crashed writer's leavings and is
    #: broken — the write section holds it for microseconds, so seconds
    #: of age is unambiguous abandonment.
    LOCK_STALE_S = 5.0

    def __init__(
        self,
        directory: str,
        verify_hook: "Optional[Callable[[str], None]]" = None,
    ):
        self.directory = os.path.join(directory, LEASE_DIR_NAME)
        os.makedirs(self.directory, exist_ok=True)
        self.verify_hook = verify_hook

    def _path(self, topic: str) -> str:
        return os.path.join(self.directory, f"{_safe_name(topic)}.json")

    def read(self, topic: str) -> "Tuple[Optional[Lease], Optional[str]]":
        try:
            with open(self._path(topic), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return None, None
        # The token is the exact body read — surrogateescape so even a
        # non-UTF-8 corrupt record round-trips byte-faithfully into the
        # CAS comparison.
        token = data.decode("utf-8", "surrogateescape")
        try:
            return Lease.from_json(data), token
        except (ValueError, KeyError):
            # A truncated/corrupt record cannot arbitrate ownership;
            # treat it as absent, but KEEP the token: a None token means
            # "expect absent" and the CAS would refuse the overwrite
            # forever.  With the wreck's own bytes as the token the next
            # write replaces it — at epoch 1, the honest floor when
            # history is gone.
            log.warning("lease: unreadable record for %r; treating as absent",
                        topic)
            return None, token

    def write(
        self, topic: str, lease: Lease, token: "Optional[str]"
    ) -> "Optional[str]":
        """Compare-and-swap under the lock: ``token`` is the record
        body the caller read (None = expect absent).  Returns the new
        token on success, None when the CAS failed or a competing
        writer won the race."""
        path = self._path(topic)
        lock = path + ".lock"
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
        except OSError as e:
            if e.errno != errno.EEXIST:
                raise
            try:
                age = time.time() - os.stat(lock).st_mtime
            except OSError:
                age = 0.0
            if age < self.LOCK_STALE_S:
                return None  # a live writer holds the section: lost race
            # Crashed writer: break the lock and take the section.
            try:
                os.unlink(lock)
            except OSError:
                pass
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
            except OSError:
                return None
        try:
            # The compare step: the record must still be exactly what
            # the caller saw when it DECIDED on this write.  A racer
            # that wrote since — even one that politely waited its turn
            # on the lock — fails the CAS here, so two instances that
            # both read "absent/expired" can never both be granted the
            # same epoch.
            try:
                with open(path, "rb") as f:
                    current = f.read().decode("utf-8", "surrogateescape")
            except FileNotFoundError:
                current = None
            if current != token:
                return None  # the state the caller decided on is gone
            body = lease.to_json()
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(body)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            if self.verify_hook is not None:
                self.verify_hook(topic)
            with open(path, "rb") as f:
                if f.read() != body:
                    return None  # a lock-bypassing racer overwrote us
            return body.decode("utf-8")
        finally:
            try:
                os.unlink(lock)
            except OSError:
                pass

    def owners(self) -> "Set[str]":
        """Every instance id currently named on a live (non-released)
        record — the rollup's federation view."""
        out: "Set[str]" = set()
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.directory, name), "rb") as f:
                    lease = Lease.from_json(f.read())
            except (OSError, ValueError, KeyError):
                continue
            if lease.owner:
                out.add(lease.owner)
        return out


class ObjectLeaseStore:
    """Lease records as ``_kta_leases/{topic}.json`` objects behind
    `io/objstore.RetryingHttp`, fenced by conditional PUTs.

    The token is the object's ETag.  A None from ``put_conditional``
    (HTTP 412) is NOT immediately a lost race: the PUT may have been
    retried across a transport error after the server applied the first
    attempt, in which case the 412 is our own write fencing us out.
    The record is read back and the race declared lost only when the
    stored owner/epoch differ from what we tried to write.
    """

    def __init__(self, http, prefix: str = f"{LEASE_DIR_NAME}/"):
        self.http = http
        self.prefix = prefix

    def _path(self, topic: str) -> str:
        return self.http.object_path(
            f"{self.prefix}{_safe_name(topic)}.json"
        )

    def read(self, topic: str) -> "Tuple[Optional[Lease], Optional[str]]":
        got = self.http.get_small(self._path(topic))
        if got is None:
            return None, None
        body, etag = got
        try:
            return Lease.from_json(body), etag
        except (ValueError, KeyError):
            # Surface the wreck's ETag: a None token would make the next
            # write an If-None-Match create that 412s against the object
            # forever — the topic would be permanently unacquirable.
            # With the ETag the next write If-Match-overwrites it.
            log.warning("lease: unreadable record for %r; treating as absent",
                        topic)
            return None, etag

    def write(
        self, topic: str, lease: Lease, token: "Optional[str]"
    ) -> "Optional[str]":
        body = lease.to_json()
        path = self._path(topic)
        if token is None:
            etag = self.http.put_conditional(path, body, if_none_match=True)
        else:
            etag = self.http.put_conditional(path, body, if_match=token)
        if etag is not None:
            return etag or "etag"
        # 412: lost race, OR our own ambiguous earlier attempt.  Read
        # back and compare — owner+epoch identify the writer uniquely
        # (epochs are monotone, so a successor can never echo ours).
        cur, cur_token = self.read(topic)
        if (
            cur is not None
            and cur.owner == lease.owner
            and cur.epoch == lease.epoch
        ):
            return cur_token or "etag"
        return None

    def owners(self) -> "Set[str]":
        out: "Set[str]" = set()
        try:
            names = self.http.list_objects(self.prefix)
        except Exception:
            return out
        for name, _size in names:
            if not name.endswith(".json"):
                continue
            topic = name[: -len(".json")]
            try:
                lease, _tok = self.read(topic)
            except Exception:
                continue
            if lease is not None and lease.owner:
                out.add(lease.owner)
        return out


@dataclasses.dataclass
class _Held:
    """The manager's local view of one held lease.  ``state`` moves
    ONLY inside `LeaseManager._transition`: held →
    released | lost, with the loss reason ("fenced" | "expired")
    recorded on the transition."""

    topic: str
    epoch: int
    expires_at: float
    token: "Optional[str]"
    state: str = "held"


class LeaseManager:
    """The acquire / renew / release / fence state machine.

    Clock-injectable (``clock`` defaults to ``time.time`` — expiry is
    WALL time, shared via the store across instances, unlike the fleet
    loop's monotonic pass clock) and store-agnostic.  Every decision
    books a ``kta_lease_*`` reason; no path is silent.
    """

    def __init__(
        self,
        store,
        instance: str,
        ttl_s: float = 30.0,
        clock: "Callable[[], float]" = time.time,
        backoff=None,
        renew_attempts: int = 3,
    ):
        if not instance:
            raise ValueError("lease manager needs a non-empty instance id")
        if ttl_s <= 0:
            raise ValueError("lease TTL must be > 0")
        self.store = store
        self.instance = instance
        self.ttl_s = float(ttl_s)
        self.clock = clock
        #: io/retry.Backoff for transient store errors during renewal
        #: (injectable sleep keeps the outage tests clockless).
        self.backoff = backoff
        self.renew_attempts = max(1, int(renew_attempts))
        self._held: "Dict[str, _Held]" = {}

    # -- the single transition point -------------------------------------------

    def _transition(self, rec: _Held, new_state: str, outcome: str) -> None:
        """Move one held lease to its next state and book WHY — the one
        place ``_Held.state`` changes, so the counters reconstruct the
        full ownership history."""
        rec.state = new_state
        if new_state == "held":
            obs_metrics.LEASE_ACQUISITIONS.labels(
                outcome=outcome, instance=self.instance
            ).inc()
            obs_metrics.LEASE_HELD.labels(
                topic=rec.topic, instance=self.instance
            ).set(1)
            if outcome == "takeover":
                obs_metrics.FLEET_FAILOVERS.labels(
                    instance=self.instance
                ).inc()
        elif new_state == "released":
            obs_metrics.LEASE_ACQUISITIONS.labels(
                outcome="released", instance=self.instance
            ).inc()
            obs_metrics.LEASE_HELD.labels(
                topic=rec.topic, instance=self.instance
            ).set(0)
        elif new_state == "lost":
            obs_metrics.LEASE_LOSSES.labels(instance=self.instance).inc()
            obs_metrics.LEASE_HELD.labels(
                topic=rec.topic, instance=self.instance
            ).set(0)
        obs_events.emit(
            "lease_transition",
            topic=rec.topic,
            instance=self.instance,
            epoch=rec.epoch,
            state=new_state,
            outcome=outcome,
        )

    # -- local views ----------------------------------------------------------

    def is_held(self, topic: str) -> bool:
        """Locally held — deliberately NOT expiry-checked here: expiry
        is enforced by the renewal path (an expired-unrenewed lease
        transitions to lost there), and the epoch fence covers the
        window in between (a stale pass's checkpoint is refused)."""
        rec = self._held.get(topic)
        return rec is not None and rec.state == "held"

    def epoch(self, topic: str) -> "Optional[int]":
        rec = self._held.get(topic)
        return rec.epoch if rec is not None and rec.state == "held" else None

    def held_topics(self) -> "List[str]":
        return sorted(
            t for t, r in self._held.items() if r.state == "held"
        )

    def known_instances(self) -> "List[str]":
        """Every instance id visible through the lease store, plus this
        one — the rollup's federation block.  A store outage degrades to
        the local view (never raises)."""
        try:
            others = self.store.owners()
        except Exception:
            others = set()
        return sorted(others | {self.instance})

    # -- decisions (every one books a kta_lease_* reason) ---------------------

    def acquire(self, topic: str) -> "Optional[int]":
        """Try to take ownership of ``topic``; returns the held epoch or
        None.  Epoch rules: no record → 1; expired, released, or
        self-owned record → record.epoch + 1; live record owned
        elsewhere → refused ("held-elsewhere").  Taking over ANOTHER
        instance's expired/released lease is a failover and books
        ``kta_fleet_failovers_total``."""
        if self.is_held(topic):
            return self._held[topic].epoch
        now = self.clock()
        try:
            cur, token = self.store.read(topic)
        except Exception as e:
            obs_metrics.LEASE_ACQUISITIONS.labels(
                outcome="store-error", instance=self.instance
            ).inc()
            log.warning("lease: store read for %r failed: %s", topic, e)
            return None
        prev_owner: "Optional[str]" = None
        if cur is None:
            epoch = 1
        elif cur.owner is None or cur.owner == self.instance:
            prev_owner = cur.owner
            epoch = cur.epoch + 1
        elif cur.expires_at <= now:
            prev_owner = cur.owner
            epoch = cur.epoch + 1
        else:
            obs_metrics.LEASE_ACQUISITIONS.labels(
                outcome="held-elsewhere", instance=self.instance
            ).inc()
            return None
        lease = Lease(
            topic=topic,
            owner=self.instance,
            epoch=epoch,
            expires_at=now + self.ttl_s,
            acquired_at=now,
        )
        try:
            new_token = self.store.write(topic, lease, token)
        except Exception as e:
            obs_metrics.LEASE_ACQUISITIONS.labels(
                outcome="store-error", instance=self.instance
            ).inc()
            log.warning("lease: store write for %r failed: %s", topic, e)
            return None
        if new_token is None:
            obs_metrics.LEASE_ACQUISITIONS.labels(
                outcome="lost-race", instance=self.instance
            ).inc()
            return None
        rec = _Held(
            topic=topic,
            epoch=epoch,
            expires_at=lease.expires_at,
            token=new_token,
        )
        self._held[topic] = rec
        outcome = (
            "takeover"
            if prev_owner is not None and prev_owner != self.instance
            else "acquired"
        )
        self._transition(rec, "held", outcome)
        return epoch

    def renew(self, topic: str) -> bool:
        """Extend a held lease's expiry (same epoch — renewal never
        changes ownership).  Degrade-not-crash: a store outage books
        "deferred" and the lease stays held while locally unexpired;
        the manager self-fences only on an OBSERVED newer epoch/other
        owner ("fenced") or on local expiry with no successful renewal
        ("expired") — both book ``kta_lease_losses_total``."""
        rec = self._held.get(topic)
        if rec is None or rec.state != "held":
            return False
        attempt = 0
        while True:
            now = self.clock()
            if now >= rec.expires_at:
                # Locally expired with no successful renewal (a pause/GC
                # longer than the TTL).  Rename has no CAS, so a blind
                # write here could clobber a successor's record — read
                # first and extend only if the record is still ours.
                try:
                    cur, tok = self.store.read(topic)
                except Exception:
                    cur, tok = None, None
                if not (
                    cur is not None
                    and cur.owner == self.instance
                    and cur.epoch == rec.epoch
                ):
                    self._transition(
                        rec, "lost",
                        "fenced" if cur is not None else "expired",
                    )
                    del self._held[topic]
                    return False
                rec.token = tok
            lease = Lease(
                topic=topic,
                owner=self.instance,
                epoch=rec.epoch,
                expires_at=now + self.ttl_s,
                acquired_at=now,
            )
            try:
                new_token = self.store.write(topic, lease, rec.token)
            except Exception as e:
                attempt += 1
                if attempt < self.renew_attempts:
                    if self.backoff is not None:
                        self.backoff.sleep_for(attempt)
                    continue
                # Store outage: defer, do not self-fence early — the
                # lease is OURS until its expiry passes (renewal-outage
                # degradation).
                if self.clock() >= rec.expires_at:
                    self._transition(rec, "lost", "expired")
                    del self._held[topic]
                    return False
                obs_metrics.LEASE_RENEWALS.labels(
                    outcome="deferred", instance=self.instance
                ).inc()
                log.warning(
                    "lease: renew of %r deferred (store outage: %s); "
                    "holding until local expiry", topic, e,
                )
                return True
            if new_token is None:
                # CAS lost: somebody else's write is in the store.  See
                # whose — a newer epoch/other owner means we are FENCED.
                self._fence_observed(rec, topic)
                return False
            rec.token = new_token
            rec.expires_at = lease.expires_at
            obs_metrics.LEASE_RENEWALS.labels(
                outcome="renewed", instance=self.instance
            ).inc()
            return True

    def _fence_observed(self, rec: _Held, topic: str) -> None:
        """A renewal CAS lost: record the loss with the right reason
        (books LEASE_LOSSES via the transition)."""
        try:
            cur, _tok = self.store.read(topic)
        except Exception:
            cur = None
        if (
            cur is not None
            and cur.owner == self.instance
            and cur.epoch == rec.epoch
        ):
            # Our own record is live after all (e.g. a racer's write
            # lost); resync the token and keep holding.
            rec.token = _tok
            rec.expires_at = cur.expires_at
            obs_metrics.LEASE_RENEWALS.labels(
                outcome="renewed", instance=self.instance
            ).inc()
            return
        self._transition(rec, "lost", "fenced")
        del self._held[topic]

    def renew_all(self) -> None:
        for topic in list(self._held):
            self.renew(topic)

    def release(self, topic: str) -> None:
        """Give the topic up cleanly: the record is rewritten with
        owner=None and the SAME epoch (kept forever — epoch monotonicity
        is the fence), so a successor acquires instantly instead of
        waiting out the TTL (the rolling-restart path)."""
        rec = self._held.get(topic)
        if rec is None or rec.state != "held":
            return
        now = self.clock()
        lease = Lease(
            topic=topic,
            owner=None,
            epoch=rec.epoch,
            expires_at=now,
            acquired_at=now,
        )
        try:
            self.store.write(topic, lease, rec.token)
        except Exception as e:
            # Best-effort: an unreleasable lease just waits out its TTL.
            log.warning("lease: release of %r failed: %s", topic, e)
        self._transition(rec, "released", "released")
        del self._held[topic]

    def release_all(self) -> None:
        for topic in list(self._held):
            self.release(topic)

    def fence(self, topic: str, reason: str = "fenced") -> None:
        """Record an externally observed fencing — the service calls
        this when `checkpoint.StaleLeaseEpochError` surfaces from a
        pass (the zombie's refused write), booking the loss under THIS
        instance's label (checkpoint.py has no instance identity)."""
        rec = self._held.get(topic)
        if rec is None or rec.state != "held":
            return
        self._transition(rec, "lost", reason)
        del self._held[topic]
