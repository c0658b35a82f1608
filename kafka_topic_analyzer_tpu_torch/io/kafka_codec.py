"""The base of the corrupt-frame error taxonomy (port of the reference's
``io/kafka_codec.py``, its error classes only; the codec is not yet
ported).  The segment reader's errors (``io/segfile.py``) derive from
`CorruptFrameError`, so a damaged dump is classified like a damaged wire
frame.
"""

from __future__ import annotations

from typing import Optional, Tuple


class KafkaProtocolError(RuntimeError):
    pass


class CorruptFrameError(KafkaProtocolError):
    """Bytes that are wrong, as opposed to a transport fault.  Corruption
    at rest is deterministic, so retrying does not help.

    ``kind`` classifies the damage; the context fields say where it is:

    - ``partition``: the partition the bytes claim or belong to
    - ``base_offset``: the frame's claimed base offset (-1 unknown)
    - ``span``: (start, end) byte range of the damage, when known
    - ``claimed_end``: one past the last offset the header claims (-1
      unknown)
    - ``num_records``: the header's record count (0 when unreadable)
    - ``crc_expected`` / ``crc_actual``: set for checksum mismatches
    """

    kind = "corrupt"

    def __init__(
        self,
        message: str,
        *,
        partition: "Optional[int]" = None,
        base_offset: int = -1,
        span: "Optional[Tuple[int, int]]" = None,
        claimed_end: int = -1,
        num_records: int = 0,
        crc_expected: "Optional[int]" = None,
        crc_actual: "Optional[int]" = None,
    ):
        super().__init__(message)
        self.partition = partition
        self.base_offset = base_offset
        self.span = span
        self.claimed_end = claimed_end
        self.num_records = num_records
        self.crc_expected = crc_expected
        self.crc_actual = crc_actual
