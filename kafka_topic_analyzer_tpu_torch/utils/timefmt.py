"""chrono-compatible UTC timestamp formatting.

The reference prints ``DateTime<Utc>`` values with chrono's ``Display``
impl — ``YYYY-MM-DD HH:MM:SS UTC`` (seen in demo_output.png; values built at
second granularity, src/metric.rs:209-211).  The report must byte-match.
"""

from __future__ import annotations

import datetime


def format_utc_seconds(ts_s: int) -> str:
    """Render an epoch-seconds timestamp exactly like chrono's
    ``DateTime<Utc>`` Display: ``1970-01-01 00:00:00 UTC``."""
    dt = datetime.datetime.fromtimestamp(int(ts_s), tz=datetime.timezone.utc)
    return dt.strftime("%Y-%m-%d %H:%M:%S UTC")


def utc_now_seconds() -> int:
    return int(datetime.datetime.now(tz=datetime.timezone.utc).timestamp())
