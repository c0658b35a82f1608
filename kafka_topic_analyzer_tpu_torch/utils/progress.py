"""indicatif-style progress spinner.

The reference updates an indicatif spinner with template
``"{spinner:.green} [{elapsed_precise}] {msg}"`` once *per message*
(src/kafka.rs:85-86, :111-113) — a measured hot-loop cost (SURVEY.md §3.3).
Here the spinner updates once per batch, rate-limited, and writes to stderr
so report output stays clean.  A rate-limited message is kept as *pending*
rather than dropped, so the final pre-finish update (the last Sq/offset
frame of the scan) always lands; and ``finish_with_message`` stays silent
when no frame was ever drawn (nothing to finish — e.g. a sub-interval scan
whose every update was elided would otherwise emit a lone "done" line).
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Optional

_FRAMES = "⠁⠂⠄⡀⢀⠠⠐⠈"


class Spinner:
    def __init__(
        self,
        enabled: "bool | None" = None,
        min_interval_s: float = 0.1,
        clock: Callable[[], float] = time.monotonic,
    ):
        if enabled is None:
            enabled = sys.stderr.isatty()
        self.enabled = enabled
        self.min_interval_s = min_interval_s
        self._clock = clock
        self.start = clock()
        self._last = 0.0
        self._frame = 0
        self._dirty = False
        self._pending: Optional[str] = None

    def _elapsed_precise(self) -> str:
        e = int(self._clock() - self.start)
        return f"{e // 3600:02d}:{(e % 3600) // 60:02d}:{e % 60:02d}"

    def _draw(self, msg: str) -> None:
        self._last = self._clock()
        frame = _FRAMES[self._frame % len(_FRAMES)]
        self._frame += 1
        sys.stderr.write(f"\r{frame} [{self._elapsed_precise()}] {msg}\x1b[K")
        sys.stderr.flush()
        self._dirty = True
        self._pending = None

    def set_message(self, msg: str) -> None:
        if not self.enabled:
            return
        if self._clock() - self._last < self.min_interval_s:
            self._pending = msg  # held, not dropped — flushed by finish
            return
        self._draw(msg)

    def finish_with_message(self, msg: str) -> None:
        if not self.enabled:
            return
        if self._pending is not None:
            # The last rate-limited update still reaches the terminal
            # before the finish line replaces it.
            self._draw(self._pending)
        if not self._dirty:
            return  # no frame was ever drawn; nothing to finish
        sys.stderr.write(f"\r  [{self._elapsed_precise()}] {msg}\x1b[K\n")
        sys.stderr.flush()
        self._dirty = False
