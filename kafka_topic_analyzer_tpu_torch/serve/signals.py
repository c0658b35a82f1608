"""Shared SIGINT/SIGTERM wiring for the long-running services (port of
the reference's ``serve/signals.py``).

One implementation for the follow service (serve/follow.py) and, once
ported, the fleet service: first signal requests a graceful stop
at the next poll boundary (final checkpoint, final report, clean exit);
a SECOND SIGINT restores the default handler so an operator can still
hard-interrupt a stuck pass (the engine's failure path then flushes the
pending tail and writes the failure snapshot).
"""

from __future__ import annotations

from typing import Callable


def install_stop_handlers(
    request_stop: "Callable[[str], None]",
) -> "Callable[[], None]":
    """Install the graceful-stop handlers; returns a restore callable.

    ``request_stop(signal_name)`` is invoked from the handler (it must be
    thread/signal safe — both services set a threading.Event).  Install
    and restore are no-ops off the main thread (``signal.signal`` raises
    ValueError there)."""
    import signal as _signal

    prev = {}
    seen = {"n": 0}

    def handler(signum, frame):
        seen["n"] += 1
        request_stop(_signal.Signals(signum).name)
        if signum == _signal.SIGINT and seen["n"] >= 2:
            _signal.signal(_signal.SIGINT, _signal.default_int_handler)

    for sig in (_signal.SIGINT, _signal.SIGTERM):
        try:
            prev[sig] = _signal.signal(sig, handler)
        except ValueError:  # not the main thread
            pass

    def restore() -> None:
        for sig, old in prev.items():
            try:
                _signal.signal(sig, old)
            except ValueError:
                pass

    return restore
