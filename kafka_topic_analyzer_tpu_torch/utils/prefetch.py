"""Background batch prefetching: overlap host ingest with the device (port
of the reference's ``utils/prefetch.py``).

The device step is asynchronous, so what remains serial is producing the
next item on the host (synthesis or reading, packing, starting its copy).
A small bounded queue filled by a worker thread overlaps it with the
main thread's dispatches.  The native shim releases the GIL, so the
overlap is real.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, TypeVar

from kafka_topic_analyzer_tpu_torch.obs import trace as obs_trace

T = TypeVar("T")

_SENTINEL = object()


class _Error:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchIterator:
    """Wraps an iterator, producing its items on a worker thread.

    An exception raised by the source is re-raised on the consuming side
    at the position it occurred; the worker stops at the first one.
    `close` (also on exit from a ``with`` block) stops the worker and
    closes the wrapped generator."""

    def __init__(self, it: Iterator[T], depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._q: "queue.Queue[object]" = queue.Queue(maxsize=depth)
        self._it = it
        self._cancel = threading.Event()
        self._source_closed = False
        #: The span context (the scan) of the thread that made this one.
        self._ctx = obs_trace.context()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _put(self, item: object) -> bool:
        """Bounded put that gives up once the consumer cancelled."""
        while not self._cancel.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _close_source(self) -> None:
        """Close the wrapped generator (once) so its ``finally`` blocks
        run.  Only called while no thread runs the generator."""
        if self._source_closed:
            return
        self._source_closed = True
        if hasattr(self._it, "close"):
            try:
                self._it.close()
            except Exception:
                pass  # a dying source must not mask the scan's own error

    def _fill(self) -> None:
        obs_trace.bind(self._ctx)
        try:
            for item in self._it:
                if not self._put(item):
                    break
        except BaseException as e:  # re-raised on the consuming side
            self._put(_Error(e))
            return
        finally:
            if self._cancel.is_set():
                self._close_source()
        self._put(_SENTINEL)

    def close(self) -> None:
        """Stop the worker and release the wrapped iterator; safe to call
        more than once."""
        self._cancel.set()
        try:  # drain, so a worker blocked on put sees the cancel
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        if not self._thread.is_alive():
            # The worker may have finished before the cancel: close the
            # now idle generator here.
            self._close_source()

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self) -> T:
        item = self._q.get()
        if item is _SENTINEL:
            raise StopIteration
        if isinstance(item, _Error):
            raise item.exc
        return item


def prefetch(it: Iterator[T], depth: int = 2) -> Iterator[T]:
    """``it`` produced on a worker thread ``depth`` items ahead; a depth
    of 0 or less passes ``it`` through."""
    if depth <= 0:
        return it
    return PrefetchIterator(it, depth)
