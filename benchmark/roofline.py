"""The card's peaks and the bytes a kernel needs, for roofline shares.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet), at its 700 W limit.
"""

#: HBM3 bandwidth, bytes per second.
H100_HBM_BYTES_PER_S = 3.35e12


def counters_merge_bytes(partitions: int) -> int:
    """``counters_merge`` adds a dispatch's ``int64[P, 7]`` counter table
    into the state's: it reads both tables and writes one (3 * 56 * P
    bytes), and adds two int64 global sums in place (read and write, 32
    bytes)."""
    return 3 * 7 * 8 * partitions + 32
