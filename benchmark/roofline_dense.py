"""The bytes the dense alive bitmap's pair kernel (``bitmap_pairs``)
needs, for its roofline share; the card's peaks are in ``roofline.py``."""

import math


def bitmap_pairs_bytes(pairs: float, bits: int) -> float:
    """``bitmap_pairs`` applies ``pairs`` (slot, aliveness) pairs to a
    ``2^bits``-slot bitmap: it reads 5 B a pair (the slot and its flag) and
    the 4-byte pair count, and reads and writes each 32-byte sector of
    words it touches.  Uniformly hashed pairs over ``N = 2^bits / 256``
    sectors touch ``N * (1 - (1 - 1/N)^pairs)`` of them on average."""
    sectors = (1 << bits) / 256
    if sectors > 1:
        touched = -sectors * math.expm1(pairs * math.log1p(-1.0 / sectors))
    else:
        touched = float(pairs > 0)
    return 5 * pairs + 4 + 2 * 32 * touched
