"""Logging setup — the reference's env_logger convention (port of the
reference package's ``utils/log.py``).

The reference initializes env_logger at startup (src/main.rs:30) and is
driven by ``RUST_LOG``.  We honor the same variable (plus ``KTA_LOG``) so a
user switching tools keeps their habits — including env_logger's
``target=level`` segments: ``KTA_LOG=kta.io=debug,error`` floods the wire
client's logger while everything else stays at ERROR.  Targets are logger
names; the ``kta`` prefix aliases the package root, so ``kta.io`` means
``kafka_topic_analyzer_tpu_torch.io`` (and every module logger under it).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Tuple

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "off": logging.CRITICAL,
}

#: env_logger-style short prefix for the package's logger tree.
_ALIAS = "kta"
_PACKAGE = "kafka_topic_analyzer_tpu_torch"


def parse_spec(spec: str) -> "Tuple[int, Dict[str, int]]":
    """env_logger spec → (default level, {target: level}).

    ``"level"`` segments set the default (first one wins, like
    env_logger's last-wins is for *conflicting* targets — bare repeats are
    junk); ``target=level`` segments configure that target's logger.
    Junk segments — unknown levels, empty targets — are ignored, and a
    spec with no usable default falls back to ERROR."""
    default: "int | None" = None
    targets: Dict[str, int] = {}
    for seg in spec.split(","):
        seg = seg.strip()
        if not seg:
            continue
        if "=" in seg:
            target, _, level = seg.partition("=")
            target = target.strip()
            level = level.strip().lower()
            if target and level in _LEVELS:
                targets[target] = _LEVELS[level]
            continue
        if default is None and seg.lower() in _LEVELS:
            default = _LEVELS[seg.lower()]
    return (logging.ERROR if default is None else default), targets


def resolve_target(target: str) -> str:
    """Map an env_logger target onto a logger name (``kta`` → package)."""
    if target == _ALIAS:
        return _PACKAGE
    if target.startswith(_ALIAS + "."):
        return _PACKAGE + target[len(_ALIAS):]
    return target


def init_logging() -> None:
    spec = os.environ.get("KTA_LOG") or os.environ.get("RUST_LOG") or "error"
    default, targets = parse_spec(spec)
    logging.basicConfig(
        level=default,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )
    # Per-target levels ride on logger-name hierarchy: setting
    # kafka_topic_analyzer_tpu_torch.io covers every module logger beneath it,
    # and the root handler (level NOTSET) passes whatever they emit.
    for target, level in targets.items():
        logging.getLogger(resolve_target(target)).setLevel(level)
