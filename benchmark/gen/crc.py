"""CRC32-C of many slices of one buffer, through ``crc32c.c``, built at
first use (`cbuild.library`)."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from benchmark.gen.cbuild import library

_SRC = Path(__file__).resolve().with_name("crc32c.c")


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = library(_SRC)
    lib.bench_crc32c_many.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.bench_crc32c_many.restype = None
    return lib


def crc32c_many(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """CRC32-C of ``buf[starts[i] : starts[i] + lens[i]]`` for every i."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    if len(starts) != len(lens):
        raise ValueError("starts and lens differ in length")
    if len(starts) and (starts.min() < 0 or (starts + lens).max() > len(buf)):
        raise ValueError("a slice lies outside the buffer")
    out = np.zeros(len(starts), dtype=np.uint32)
    _lib().bench_crc32c_many(buf.ctypes.data, starts.ctypes.data,
                             lens.ctypes.data, len(starts), out.ctypes.data)
    return out
