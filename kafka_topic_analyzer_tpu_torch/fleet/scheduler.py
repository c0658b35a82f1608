"""The fleet admission scheduler: N topic scans, one budget (port of the
reference's ``fleet/scheduler.py``; its decisions are the reference's,
call for call).

The ingest worker threads and the dispatch depth a fleet shares are
global.  This module shares them:

- admission: a topic with work asks for a grant; up to
  ``max_concurrent`` topics hold one at once, each with at least one
  ingest worker and one dispatch-depth token, and the rest wait until
  budget returns.  Batch fleets plan their waves with the greedy-LPT rule
  of `parallel.ingest.shard_partitions(weights=)` (topics descend by
  weight onto the least-loaded wave) and split the workers within a wave
  with `parallel.ingest.allocate_row_workers`;
- rebalance (between follow polls): the scan doctor's per-topic verdicts
  move budget — a dispatch-bound scan sheds a worker to the pool, an
  ingest-bound one sheds dispatch share down to 1 and draws workers from
  the pool.  Grants change only between passes, so a pass's fold order
  never moves.

At every point the granted workers and dispatch tokens stay within their
budgets, every grant keeps at least 1 of each, and a topic's workers
never exceed its partition count.  Every admission decision books one
``kta_fleet_admissions_total`` reason.  The scheduler is bookkeeping only:
it touches no source, backend or drive loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.parallel.ingest import (
    allocate_row_workers,
    shard_partitions,
)


@dataclasses.dataclass
class Grant:
    """One admitted topic's share of the global budgets."""

    workers: int
    dispatch_depth: int


@dataclasses.dataclass(frozen=True)
class TopicSeed:
    """Admission input for one topic: its name and the two weights the
    scheduler balances on (the partition count bounds the useful worker
    grant; the lag orders who goes first)."""

    name: str
    partitions: int
    #: Records behind the head; batch fleets seed the retained count.
    #: 0 = nothing to do.
    lag: int = 0

    @property
    def weight(self) -> int:
        """LPT weight: the lag when known, else the partition count."""
        return self.lag if self.lag > 0 else self.partitions


class FleetScheduler:
    def __init__(
        self,
        worker_budget: int,
        dispatch_budget: int,
        max_concurrent: int,
        instance: str = "solo",
    ):
        if worker_budget < 1:
            raise ValueError("fleet worker budget must be >= 1")
        if dispatch_budget < 1:
            raise ValueError("fleet dispatch budget must be >= 1")
        if max_concurrent < 1:
            raise ValueError("fleet concurrency must be >= 1")
        self.worker_budget = worker_budget
        self.dispatch_budget = dispatch_budget
        self.max_concurrent = max_concurrent
        #: Analyzer instance id on every booked decision ("solo" outside a
        #: multi-instance fleet).
        self.instance = instance
        #: topic -> live Grant (the budget ledger).
        self._grants: "Dict[str, Grant]" = {}
        #: topic -> partition count (the per-topic worker clamp).
        self._partitions: "Dict[str, int]" = {}

    # -- ledger views ---------------------------------------------------------

    def grants(self) -> "Dict[str, Grant]":
        return {t: dataclasses.replace(g) for t, g in self._grants.items()}

    def grant_for(self, topic: str) -> "Grant | None":
        g = self._grants.get(topic)
        return dataclasses.replace(g) if g is not None else None

    @property
    def workers_granted(self) -> int:
        return sum(g.workers for g in self._grants.values())

    @property
    def dispatch_granted(self) -> int:
        return sum(g.dispatch_depth for g in self._grants.values())

    @property
    def active(self) -> int:
        return len(self._grants)

    # -- wave planning (batch fleets) -----------------------------------------

    def plan_waves(self, seeds: "Sequence[TopicSeed]") -> "List[List[str]]":
        """Group the topics into waves of at most ``max_concurrent``,
        balanced by weight with `shard_partitions`' greedy LPT.  Waves run
        in order; the scans of a wave run concurrently."""
        if not seeds:
            return []
        n_waves = max(1, -(-len(seeds) // self.max_concurrent))
        idx_groups = shard_partitions(
            list(range(len(seeds))),
            n_waves,
            weights={i: s.weight for i, s in enumerate(seeds)},
        )
        # LPT balances weight, not cardinality: move the lightest members
        # of an overfull group to the emptiest group until no wave exceeds
        # the concurrency bound.
        groups = [list(g) for g in idx_groups]
        while True:
            over = next(
                (g for g in groups if len(g) > self.max_concurrent), None
            )
            if over is None:
                break
            under = min(groups, key=len)
            if len(under) >= self.max_concurrent:
                groups.append([])
                under = groups[-1]
            lightest = min(over, key=lambda i: (seeds[i].weight, i))
            over.remove(lightest)
            under.append(lightest)
        return [[seeds[i].name for i in sorted(g)] for g in groups if g]

    # -- admission ------------------------------------------------------------

    def admit(
        self,
        ready: "Sequence[TopicSeed]",
        reason: str = "admitted-poll",
    ) -> "Dict[str, Grant]":
        """Grant budget to as many of ``ready`` as fit, heaviest first.

        Admitted topics keep their grants until `release`.  New ones split
        the ungranted workers with `allocate_row_workers` (at least 1
        each, clamped at the partition count) and the ungranted dispatch
        tokens evenly (at least 1 each).  The rest are deferred (booked;
        the next poll offers them again).  Returns the grants of the
        topics admitted by this call."""
        new = [
            s for s in sorted(ready, key=lambda s: (-s.weight, s.name))
            if s.name not in self._grants
        ]
        admitted: "Dict[str, Grant]" = {}
        if not new:
            return admitted
        free_slots = self.max_concurrent - self.active
        free_workers = self.worker_budget - self.workers_granted
        free_dispatch = self.dispatch_budget - self.dispatch_granted
        n = min(len(new), free_slots, free_workers, free_dispatch)
        if n > 0:
            take = new[:n]
            split = allocate_row_workers(
                free_workers,
                {i: max(1, s.partitions) for i, s in enumerate(take)},
            )
            depth_each = max(1, free_dispatch // n)
            spent_dispatch = 0
            for i, s in enumerate(take):
                depth = min(depth_each, free_dispatch - spent_dispatch - (n - i - 1))
                depth = max(1, depth)
                spent_dispatch += depth
                g = Grant(workers=max(1, split.get(i, 1)), dispatch_depth=depth)
                self._grants[s.name] = g
                self._partitions[s.name] = max(1, s.partitions)
                admitted[s.name] = dataclasses.replace(g)
                obs_metrics.FLEET_ADMISSIONS.labels(
                    reason=reason, instance=self.instance
                ).inc()
        for _ in new[n:]:
            obs_metrics.FLEET_ADMISSIONS.labels(
                reason="deferred-budget", instance=self.instance
            ).inc()
        obs_metrics.FLEET_TOPICS_ACTIVE.labels(instance=self.instance).set(
            self.active
        )
        return admitted

    def skip_idle(self, count: int) -> None:
        """Book topics that polled at the head with nothing to do (an
        admission decision too: the answer was "no work")."""
        for _ in range(max(0, int(count))):
            obs_metrics.FLEET_ADMISSIONS.labels(
                reason="skipped-empty", instance=self.instance
            ).inc()

    def release(self, topic: str) -> None:
        """Return a finished, caught-up or failed topic's budget."""
        if self._grants.pop(topic, None) is not None:
            obs_metrics.FLEET_ADMISSIONS.labels(
                reason="released", instance=self.instance
            ).inc()
        obs_metrics.FLEET_TOPICS_ACTIVE.labels(instance=self.instance).set(
            self.active
        )

    # -- the rebalance rule (between polls) -----------------------------------

    def rebalance(self, verdicts: "Dict[str, str]") -> int:
        """Move budget between live grants on doctor verdicts; returns the
        number of moves (booked on ``kta_fleet_rebalances_total``).

        Dispatch-bound scans shed one worker each to the pool and keep
        their dispatch share; ingest-bound scans shed dispatch share down
        to 1, then draw workers from the pool one at a time, the most
        starved (partitions per worker) first, until the pool is dry or
        every ingest-bound scan sits at its partition clamp.  Balanced
        scans hold still."""
        moves = 0
        for t in sorted(verdicts):
            g = self._grants.get(t)
            if g is None:
                continue
            v = verdicts[t]
            if v == "dispatch-bound" and g.workers > 1:
                g.workers -= 1
                moves += 1
            elif v == "ingest-bound" and g.dispatch_depth > 1:
                g.dispatch_depth = 1
                moves += 1
        pool = self.worker_budget - self.workers_granted
        starved = [
            t for t in sorted(verdicts)
            if verdicts[t] == "ingest-bound" and t in self._grants
        ]
        while pool > 0 and starved:
            best = None
            for t in starved:
                g = self._grants[t]
                clamp = self._partitions.get(t, g.workers)
                if g.workers >= clamp:
                    continue
                ratio = clamp / g.workers
                if best is None or ratio > best[0]:
                    best = (ratio, t)
            if best is None:
                break
            self._grants[best[1]].workers += 1
            pool -= 1
            moves += 1
        if moves:
            obs_metrics.FLEET_REBALANCES.labels(instance=self.instance).inc(
                moves
            )
        return moves
