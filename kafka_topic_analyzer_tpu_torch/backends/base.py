"""Backend protocol + factory + the dispatch queue (port of the reference's
``backends/base.py``).

The reference bounds in-flight *superbatch* dispatches with its
`DispatchQueue`; so does the port, with a CUDA event recorded behind each
dispatch (one packed row at K = 1, K rows at ``--superbatch K``) as the
completion token.
"""

from __future__ import annotations

import abc
import collections
import functools
import time

from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.records import RecordBatch
from kafka_topic_analyzer_tpu_torch.results import TopicMetrics


class ReadyToken:
    """Completion token of a dispatch that finished when it returned (a
    fold on the host): the same ``query``/``synchronize`` surface as the
    ``torch.cuda.Event`` a CUDA dispatch records."""

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        return None


#: The one host-side token (stateless).
READY = ReadyToken()


class DispatchQueue:
    """Bounded in-flight dispatch tracking (``--dispatch-depth``).

    Device dispatch is asynchronous: without a bound, a fast ingest side
    could stack arbitrarily many folds (and their staged device buffers)
    behind a slow device.  This queue caps the in-flight count at
    ``depth`` using per-dispatch completion tokens — a ``torch.cuda.Event``
    recorded on the backend's stream right behind the fold, which
    completes exactly when the fold (and therefore its host→device copy)
    has; `READY` on the host.  A token needs ``query()`` (completed yet?)
    and ``synchronize()`` (wait for it).

    Contract: all in-flight bookkeeping lives HERE, and every dispatch
    site calls ``throttle()`` before launching + ``launched()`` after — so
    no drive loop can ever hold more than ``depth`` dispatches in flight.
    Blocking inside ``throttle`` is the backpressure that reaches the
    ingest side (the engine thread stops draining the prefetch queue,
    which fills, which stalls the worker), and it is the one place a
    device that falls behind shows up on the host: the scan doctor reads
    it as dispatch-bound (obs/doctor.py).
    """

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError("dispatch depth must be >= 1")
        self.depth = depth
        self._inflight: "collections.deque" = collections.deque()

    def __len__(self) -> int:
        return len(self._inflight)

    def throttle(self) -> None:
        """Block until fewer than ``depth`` dispatches are in flight —
        call BEFORE launching the next one.

        Time spent blocked here is booked on
        ``kta_dispatch_throttle_seconds_total`` UNCONDITIONALLY (flight
        recorder on or off): this wait is the backpressure at the launch
        site, and the one signal that directly decides dispatch-bound vs
        ingest-bound (obs/doctor.py)."""
        self._reap()
        if len(self._inflight) < self.depth:
            return
        t0 = time.perf_counter()
        try:
            while len(self._inflight) >= self.depth:
                self._retire(block=True)
        finally:
            obs_metrics.DISPATCH_THROTTLE_SECONDS.inc(
                time.perf_counter() - t0
            )

    def launched(self, token, batches: int) -> None:
        """Record a dispatch just launched; ``token`` completes with it."""
        self._inflight.append((token, time.perf_counter(), batches))
        obs_metrics.DISPATCH_INFLIGHT.set(len(self._inflight))
        obs_metrics.SUPERBATCH_SIZE.observe(batches)

    def drain(self) -> None:
        """Retire every in-flight dispatch (finalize)."""
        while self._inflight:
            self._retire(block=True)

    def _reap(self) -> None:
        """Opportunistically retire already-completed dispatches so the
        latency histogram and in-flight gauge stay fresh without blocking."""
        while self._inflight and self._inflight[0][0].query():
            self._retire(block=False)

    def _retire(self, block: bool) -> None:
        token, t0, _batches = self._inflight[0]
        if block:
            token.synchronize()
        self._inflight.popleft()
        obs_metrics.DISPATCH_SECONDS.observe(time.perf_counter() - t0)
        obs_metrics.DISPATCH_INFLIGHT.set(len(self._inflight))


class MetricBackend(abc.ABC):
    """Batched replacement for the reference's ``MetricHandler`` seam
    (src/kafka.rs:18-20): updates fold whole record batches, results are read
    once at the end.

    Contract:
    - `update` must be called with batches whose per-partition record order
      matches offset order (records.py ordering contract);
    - `update` may be asynchronous (device dispatch); `finalize` synchronizes
      and returns host-side results.

    The defaults describe a backend that folds decoded batches on the
    calling thread (the numpy oracle); the torch backend overrides them.
    """

    #: Whether `update` takes rows packed on the ingest side (`prepare`,
    #: `make_fused_sink`), whose host→device wire the scan accounts.
    packs_rows = False
    #: The torch device the state lives on; None for a host-only backend.
    device = None
    #: Folds allowed in flight (``--dispatch-depth``); 1 where `update`
    #: finishes before it returns.
    dispatch_depth = 1
    #: Batches folded per dispatch (``--superbatch``, resolved); above 1
    #: the engine hands K staged batches to `update_superbatch`.
    superbatch_k = 1
    #: Pack through the native shim (loaded), and whether ``--native``
    #: asked for it (loaded or not).
    use_native = False
    native_requested = False
    #: Whether `get_state` and `set_state` carry the state across a
    #: snapshot (``--snapshot-dir``, ``--resume``).  The numpy oracle has
    #: none, like the reference's, and its scans continue without.
    snapshots = False

    def __init__(self, config: AnalyzerConfig):
        self.config = config

    def get_state(self) -> "dict":
        """The state as host arrays keyed by leaf path (the snapshot's
        form, `checkpoint.Leaves`), folding every batch `update` took."""
        raise NotImplementedError(f"{type(self).__name__} takes no snapshots")

    def set_state(self, leaves: "dict") -> None:
        """Replace the state with ``leaves`` (`get_state`'s form)."""
        raise NotImplementedError(f"{type(self).__name__} takes no snapshots")

    def drain_dispatch(self) -> None:
        """Retire every in-flight dispatch without launching one (the
        engine's failure path, before its snapshot); nothing to do where
        `update` finishes before it returns."""

    def update_superbatch(self, staged: list) -> None:
        """Fold up to `superbatch_k` staged batches in one dispatch, in
        list order; only a backend with ``superbatch_k`` > 1 has one."""
        raise NotImplementedError(f"{type(self).__name__} has no superbatch")

    def prepare(self, batch: RecordBatch):
        """Stage a decoded batch for `update`, on the ingest side: the
        identity unless the backend packs rows."""
        return batch

    def make_fused_sink(self, dense_of):
        """A `packing.FusedPackSink` whose rows `update` takes; only a
        backend that packs rows has one."""
        raise NotImplementedError(f"{type(self).__name__} packs no rows")

    @abc.abstractmethod
    def update(self, batch: RecordBatch) -> None:
        ...

    @abc.abstractmethod
    def finalize(self) -> TopicMetrics:
        ...


def _timed(fn, hist):
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        with hist.time():
            return fn(self, *args, **kwargs)
    return wrapped


def instrument_steps(cls):
    """Class decorator for concrete backends: record step-dispatch and
    finalize latency into the obs histograms.  Asynchronous backends
    therefore book host time — the enqueue of the fold plus any real wait
    inside it (the dispatch throttle) — never device time: nothing here
    synchronizes, and the device side lives in the ``--profile-dir``
    trace."""
    cls.update = _timed(cls.__dict__["update"], obs_metrics.BACKEND_STEP_SECONDS)
    cls.finalize = _timed(
        cls.__dict__["finalize"], obs_metrics.BACKEND_FINALIZE_SECONDS
    )
    return cls


def make_backend(
    name: str,
    config: AnalyzerConfig,
    device: "str | None" = None,
    use_native: bool = False,
    native_requested: "bool | None" = None,
    dispatch=None,
) -> MetricBackend:
    """Factory for ``--backend {cpu,tpu,gpu}``: ``cpu`` is the numpy exact
    oracle, which never touches torch's device layer (``device`` is not
    read); ``gpu`` and its reference spelling ``tpu`` are the torch
    backend on ``device`` (CUDA unless the caller asks for the CPU), which
    raises when CUDA is asked for and absent.  ``dispatch`` (a
    `config.DispatchConfig`) sizes the torch backend's superbatch and
    in-flight bound; the oracle dispatches nothing."""
    if name == "cpu":
        from kafka_topic_analyzer_tpu_torch.backends.cpu import CpuExactBackend

        return CpuExactBackend(config)
    if name in ("gpu", "tpu"):
        from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend

        return TorchBackend(
            config, device=device, use_native=use_native,
            native_requested=native_requested, dispatch=dispatch,
        )
    raise ValueError(
        f"unknown backend {name!r} (expected 'cpu', 'gpu' or 'tpu')"
    )
