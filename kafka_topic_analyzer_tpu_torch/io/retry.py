"""Transport-failure recovery primitives for the live Kafka scan (port of
the reference's ``io/retry.py``).

The wire client (io/kafka_wire.py) retries *protocol*-level fetch errors,
but a broker restart, connection reset, or truncated response used to
abort the whole scan and discard every accumulated sketch.  This module
holds the pure, clock-injectable pieces of the recovery substrate:

- `Backoff`: capped exponential delay with jitter (librdkafka-style
  retry.backoff.ms / reconnect.backoff.max.ms semantics), with the random
  source and sleep function injectable so the schedule unit-tests
  deterministically with no sockets and no real sleeping;
- `PartitionRetryBudget`: per-partition consecutive-transport-failure
  accounting with the degraded transition — a partition that exhausts its
  budget is *dropped from the scan and reported*, never raised on, so the
  remaining partitions still finish (graceful degradation).

Both are driven by `KafkaWireSource._batches_impl`; neither touches a
socket.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, Optional

from kafka_topic_analyzer_tpu_torch.config import TransportRetryConfig
from kafka_topic_analyzer_tpu_torch.obs import events as obs_events
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics


class Backoff:
    """Capped exponential backoff: attempt k (1-based) sleeps

        min(backoff_max_ms, backoff_ms * 2**(k-1)) * U[1-jitter, 1+jitter]

    with the jittered value re-capped at backoff_max_ms so the configured
    ceiling is a hard bound.  ``rand`` (uniform [0,1) source) and ``sleep``
    are injectable for deterministic tests.
    """

    def __init__(
        self,
        config: TransportRetryConfig,
        rand: Optional[Callable[[], float]] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.config = config
        self._rand = rand if rand is not None else random.random
        self._sleep = sleep

    def delay_ms(self, attempt: int) -> float:
        """Jittered delay for the given 1-based consecutive-failure count."""
        if attempt < 1:
            return 0.0
        c = self.config
        # Cap the exponent before shifting: attempt counts are unbounded
        # (a partition past its budget stops retrying, but the scan-level
        # round counter is not) and 2**k must not overflow into bignums.
        base = min(c.backoff_max_ms, c.backoff_ms * (1 << min(attempt - 1, 32)))
        jittered = base * (1.0 - c.jitter + 2.0 * c.jitter * self._rand())
        return min(float(c.backoff_max_ms), jittered)

    def sleep_for(self, attempt: int) -> float:
        """Sleep the schedule's delay for ``attempt``; returns seconds slept."""
        s = self.delay_ms(attempt) / 1000.0
        if s > 0:
            note_backoff_sleep(s)
            self._sleep(s)
        return s


def note_backoff_sleep(seconds: float) -> None:
    """Book a backoff sleep in the telemetry counters — shared by
    ``Backoff.sleep_for`` and the wire client's deferred-leader sleeps
    (which pace to a deadline rather than calling ``sleep_for``)."""
    obs_metrics.BACKOFF_SLEEPS.inc()
    obs_metrics.BACKOFF_SLEEP_SECONDS.inc(seconds)


class PartitionRetryBudget:
    """Consecutive-transport-failure counter per partition.

    ``record_failure`` returns True exactly once — on the failure that
    exhausts the partition's budget — at which point the caller removes the
    partition from the scan and records it in its degraded set.  Any
    successfully-read response covering the partition resets its count
    (the budget bounds *consecutive* failures, mirroring the protocol-level
    ``error_streak``).
    """

    def __init__(self, budget: int):
        if budget < 1:
            raise ValueError("retry budget must be >= 1")
        self.budget = budget
        self.failures: Dict[int, int] = {}
        #: partition -> reason string for every degraded transition.
        self.degraded: Dict[int, str] = {}

    def record_failure(self, partition: int, reason: str) -> bool:
        if partition in self.degraded:
            return False
        n = self.failures.get(partition, 0) + 1
        self.failures[partition] = n
        if n >= self.budget:
            self.degraded[partition] = (
                f"{n} consecutive transport failures (last: {reason})"
            )
            obs_metrics.RETRY_BUDGET_EXHAUSTIONS.inc()
            obs_events.emit(
                "retry_budget_exhausted",
                partition=partition,
                reason=self.degraded[partition],
            )
            return True
        return False

    def record_success(self, partition: int) -> None:
        self.failures.pop(partition, None)
