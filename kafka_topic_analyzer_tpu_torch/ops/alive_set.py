"""The exact alive-key set: an open-addressing hash set keyed by the full
u32 bitmap slot, with one aliveness bit an entry (the port's own; the
reference keeps the dense bitmap of ``ops/bitmap.py``).

A compacted audit touches far fewer slots than the bitmap's 2^32: the demo
topic's 8M keys, a CDC table's few million rows.  The set holds only the
slots that were set, at 4 B and one bit an entry, and gives the dense
bitmap's answer bit for bit: a set pair finds or inserts its slot and sets
its bit; a clear pair clears the bit of a slot that is present and inserts
nothing; the alive count is the number of set bits.  fnv32 collisions
therefore conflate keys exactly as they do in the bitmap, and a slot at or
past ``2^bits`` changes nothing in either.

Layout (``AliveSetState`` in ``models/state.py``), all ``int32`` bit
patterns (`_torch_support`):

- ``keys[C]``: C a power of two, `EMPTY` (``0xFFFFFFFF``) in a free entry;
- ``alive[C / 32]``: entry ``i``'s bit is bit ``i % 32`` of word ``i / 32``;
- ``meta[4]``: entries inserted (`ENTRIES`), the aliveness of slot
  ``0xFFFFFFFF`` itself (`TOP_BIT`: the one slot the empty marker cannot
  key), an overflow flag (`FULL`: a probe found no free entry, which the
  sizing rules out) and a spare word: `set_nbytes` bytes in all.

A table's home entry for a slot is murmur3's finalizer of it, masked to C;
inserts probe linearly.  CUDA tensors go through the hand-written kernels
of ``csrc/alive_set.cu`` (apply, rehash, count: one launch each); CPU
tensors through the numpy twins here, which leave the same set (perhaps
at other entries) and the same count.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from kafka_topic_analyzer_tpu_torch import _build
from kafka_topic_analyzer_tpu_torch.ops.bitmap import bitmap_num_words

#: The free entry's key (as an int32 bit pattern: -1).
EMPTY = 0xFFFFFFFF
#: ``meta``'s words.
ENTRIES, TOP_BIT, FULL = 0, 1, 2
META_WORDS = 4
#: A new set's entries.
MIN_CAPACITY = 1 << 16

_I32 = torch.int32
_U8 = torch.uint8
#: The C entries' argument records (``KtaSetApplyArgs``,
#: ``KtaSetRehashArgs``, ``KtaSetCountArgs`` in the source).
_APPLY = _build.Kernel("alive_set", "kta_alive_set_apply",
                       struct.Struct("<QQQQQQqQQQq"))
_REHASH = _build.Kernel("alive_set", "kta_alive_set_rehash",
                        struct.Struct("<QQqQQQQq"))
_COUNT = _build.Kernel("alive_set", "kta_alive_set_count",
                       struct.Struct("<QqQQQq"))


def capacity_limit(bits: int) -> int:
    """The most entries a set may hold in place of a ``2^bits``-slot
    bitmap: its keys at most a quarter of the bitmap's bytes (``2^bits /
    8``), 2^25 entries (128 MiB) at 2^32 slots; 0 below 2^7 slots."""
    return (1 << bits) >> 7


def set_nbytes(capacity: int) -> int:
    """Device bytes of a set of ``capacity`` entries: keys, bits, meta."""
    return 4 * capacity + capacity // 8 + 4 * META_WORDS


def capacity_for(capacity: int, entries: int, bound: int) -> int:
    """The least power-of-two multiple of ``capacity`` that keeps the
    ``entries`` last counted at a load of at most 1/2, and ``bound`` (an
    upper bound on the entries after the next apply) at most 3/4."""
    while 2 * entries > capacity or 4 * bound > 3 * capacity:
        capacity *= 2
    return capacity


# ---------------------------------------------------------------------------
# the numpy twins (CPU tensors)


def _u32(t: torch.Tensor) -> np.ndarray:
    """A CPU int32 tensor's words as a uint32 view (writes land in it)."""
    return t.numpy().view(np.uint32)


def _home(s: np.ndarray) -> np.ndarray:
    """murmur3's 32-bit finalizer (``home`` in the CUDA source)."""
    h = s.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def _probe(keys: np.ndarray, slots: np.ndarray, insert: bool):
    """Each of ``slots``' (distinct, none `EMPTY`) entries in ``keys``:
    found, or inserted when ``insert``; -1 where absent and not inserted,
    or where the table had no free entry (``full``).  Returns ``(entries,
    inserted, full)``.  All probes advance together, one entry a round;
    among inserts that meet one free entry, the first claims it and the
    rest read its key at the next round, as ``atomicCAS`` resolves
    them."""
    mask = keys.size - 1
    pos = (_home(slots) & np.uint32(mask)).astype(np.int64)
    out = np.full(slots.size, -1, np.int64)
    todo = np.arange(slots.size)
    inserted = 0
    for _ in range(keys.size):
        if not todo.size:
            return out, inserted, False
        at = pos[todo]
        k = keys[at]
        hit = k == slots[todo]
        out[todo[hit]] = at[hit]
        free = k == EMPTY
        done = hit.copy()
        if insert:
            cand = np.flatnonzero(free)
            _, first = np.unique(at[cand], return_index=True)
            won = cand[first]
            keys[at[won]] = slots[todo[won]]
            out[todo[won]] = at[won]
            inserted += won.size
            done[won] = True
            move = ~hit & ~free
        else:
            done |= free
            move = ~done
        pos[todo[move]] = (at[move] + 1) & mask
        todo = todo[~done]
    return out, inserted, bool(todo.size)


def _set_bits(words: np.ndarray, entries: np.ndarray, on: bool) -> None:
    bit = np.left_shift(np.uint32(1), (entries & 31).astype(np.uint32))
    if on:
        np.bitwise_or.at(words, entries >> 5, bit)
    else:
        np.bitwise_and.at(words, entries >> 5, ~bit)


def alive_set_apply_plain(keys, alive, meta, slot, alive_flag, n_pairs,
                          bits: int) -> None:
    """`alive_set_apply` on CPU tensors, in place."""
    n = min(int(n_pairs), slot.shape[0])
    s = _u32(slot)[:n]
    f = alive_flag.numpy()[:n] != 0
    keep = s.astype(np.uint64) < (1 << bits)
    s, f = s[keep], f[keep]
    m = _u32(meta)
    top = s == EMPTY
    if top.any():
        m[TOP_BIT] = int(f[top][0])
    s, f = s[~top], f[~top]
    k, w = _u32(keys), _u32(alive)
    set_at, inserted, full = _probe(k, s[f], insert=True)
    clear_at, _, _ = _probe(k, s[~f], insert=False)
    m[ENTRIES] += inserted
    if full:
        m[FULL] = 1
    _set_bits(w, set_at[set_at >= 0], True)
    _set_bits(w, clear_at[clear_at >= 0], False)


def alive_set_rehash_plain(old_keys, old_alive, keys, alive) -> None:
    """`alive_set_rehash` on CPU tensors, in place."""
    ok = _u32(old_keys)
    idx = np.flatnonzero(ok != EMPTY)
    on = (_u32(old_alive)[idx >> 5] >> (idx & 31).astype(np.uint32)) & 1
    at, _, _ = _probe(_u32(keys), ok[idx], insert=True)
    _set_bits(_u32(alive), at[on.astype(bool)], True)


def alive_set_count_plain(alive, meta) -> torch.Tensor:
    """`alive_set_count` on CPU tensors."""
    m = _u32(meta)
    count = int(np.bitwise_count(_u32(alive)).sum()) + int(m[TOP_BIT] & 1)
    return torch.tensor([count, int(m[ENTRIES]), int(m[FULL])], dtype=torch.int64)


# ---------------------------------------------------------------------------
# the entries


def _check(what: str, tensors: dict) -> torch.device:
    """Raise unless every tensor is contiguous, of its dtype (``flag``
    uint8, the rest int32) and on one CPU or CUDA device; return it."""
    try:
        devices = {t.device for t in tensors.values()}
        if len(devices) != 1:
            raise ValueError(f"{what} device mismatch: " + ", ".join(
                f"{name} on {t.device}" for name, t in tensors.items()))
        for name, t in tensors.items():
            want = _U8 if name == "flag" else _I32
            if t.dtype is not want:
                raise TypeError(f"{what} needs {want} {name}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{what} needs contiguous tensors")
    except AttributeError:  # an argument that is not a tensor
        got = [type(a).__name__ for a in tensors.values()
               if not isinstance(a, torch.Tensor)]
        raise TypeError(f"{what} takes tensors, got {', '.join(got)}") from None
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")
    return dev


def _capacity(what: str, keys, alive, meta=None) -> int:
    """A table's entries: a power of two of at least 32, with 1/32 as
    many bit words and `META_WORDS` meta words."""
    capacity = keys.numel()
    if capacity < 32 or capacity & (capacity - 1) or alive.numel() * 32 != capacity \
            or (meta is not None and meta.numel() != META_WORDS):
        raise ValueError(
            f"{what} needs a power-of-two table of at least 32 keys, 1/32 as "
            f"many bit words and {META_WORDS} meta words, got {capacity}, "
            f"{alive.numel()} and {None if meta is None else meta.numel()}"
        )
    return capacity


def alive_set_apply(
    keys: torch.Tensor,        # int32[C] slot bit patterns, EMPTY free
    alive: torch.Tensor,       # int32[C / 32] an entry's aliveness bit
    meta: torch.Tensor,        # int32[4] ENTRIES, TOP_BIT, FULL, spare
    slot: torch.Tensor,        # int32[T] u32 bit patterns; prefix n_pairs live
    alive_flag: torch.Tensor,  # uint8[T] 1 = the slot's last record had a value
    n_pairs: torch.Tensor,     # int32 scalar — live prefix length
    bits: int,
) -> None:
    """Apply host-deduped (slot, aliveness) pairs to the set, in place.
    The caller keeps the set at most 3/4 full after it (`capacity_for`).

    CUDA tensors launch the kernel on the current stream (and add one to
    ``alive_set_apply.launches``); it reads ``n_pairs`` on the device, so
    nothing waits for the host.  CPU tensors take
    `alive_set_apply_plain`.  Anything else raises."""
    what = "alive_set_apply"
    dev = _check(what, dict(keys=keys, alive=alive, meta=meta, slot=slot,
                            flag=alive_flag, n_pairs=n_pairs))
    capacity = _capacity(what, keys, alive, meta)
    if slot.dim() != 1 or alive_flag.shape != slot.shape or n_pairs.numel() != 1:
        raise ValueError(
            f"{what} needs 1-d slots and flags of one length and one "
            f"n_pairs, got {tuple(slot.shape)}, {tuple(alive_flag.shape)} "
            f"and {tuple(n_pairs.shape)}"
        )
    if dev.type == "cpu":
        alive_set_apply_plain(keys, alive, meta, slot, alive_flag, n_pairs, bits)
        return
    _APPLY.launch(
        dev, keys.data_ptr(), alive.data_ptr(), meta.data_ptr(),
        slot.data_ptr(), alive_flag.data_ptr(), n_pairs.data_ptr(),
        slot.shape[0], capacity, 1 << bits,
    )
    alive_set_apply.launches += 1


#: Kernel launches since import (or since a caller reset it to 0).
alive_set_apply.launches = 0


def alive_set_rehash(old_keys, old_alive, keys, alive) -> None:
    """Insert every entry of the table ``old_keys``/``old_alive`` into the
    empty, larger ``keys``/``alive`` (``keys`` all `EMPTY`, ``alive`` all
    0), with its aliveness bit: the grow.  The entries' count (the
    caller's meta) does not change.  CUDA tensors launch one kernel on the
    current stream (and add one to ``alive_set_rehash.launches``)."""
    what = "alive_set_rehash"
    dev = _check(what, dict(old_keys=old_keys, old_alive=old_alive, keys=keys,
                            alive=alive))
    old = _capacity(what, old_keys, old_alive)
    capacity = _capacity(what, keys, alive)
    if capacity <= old:
        raise ValueError(f"{what} needs a larger table, got {old} -> {capacity} keys")
    if dev.type == "cpu":
        alive_set_rehash_plain(old_keys, old_alive, keys, alive)
        return
    _REHASH.launch(dev, old_keys.data_ptr(), old_alive.data_ptr(), old,
                   keys.data_ptr(), alive.data_ptr(), capacity)
    alive_set_rehash.launches += 1


#: Kernel launches since import (or since a caller reset it to 0).
alive_set_rehash.launches = 0


def alive_set_count(alive: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """``int64[3]`` on the tensors' device: the alive count (the set
    bits and slot ``0xFFFFFFFF``'s), the entries inserted and the
    overflow flag.  On CUDA one launch on the current stream (adding one
    to ``alive_set_count.launches``), which nothing waits for until the
    caller reads the result."""
    what = "alive_set_count"
    dev = _check(what, dict(alive=alive, meta=meta))
    if meta.numel() != META_WORDS:
        raise ValueError(f"{what} needs {META_WORDS} meta words")
    if dev.type == "cpu":
        return alive_set_count_plain(alive, meta)
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    _COUNT.launch(dev, alive.data_ptr(), alive.numel(), meta.data_ptr(),
                  out.data_ptr())
    alive_set_count.launches += 1
    return out


#: Kernel launches since import (or since a caller reset it to 0).
alive_set_count.launches = 0


# ---------------------------------------------------------------------------
# the dense words, on the host


def alive_set_slots(keys: np.ndarray, alive: np.ndarray, meta: np.ndarray,
                    bits: int) -> np.ndarray:
    """The alive slots (``uint32``) of a set's host copy: each alive
    entry's slot, and slot ``0xFFFFFFFF`` when `TOP_BIT` says so; none at
    or past ``2^bits``."""
    keys = np.asarray(keys).view(np.uint32)
    bitw = np.asarray(alive).view(np.uint32)
    idx = np.flatnonzero(keys != EMPTY)
    on = ((bitw[idx >> 5] >> (idx & 31).astype(np.uint32)) & 1).astype(bool)
    slots = keys[idx[on]]
    if np.asarray(meta).view(np.uint32)[TOP_BIT] & 1:
        slots = np.append(slots, np.uint32(EMPTY))
    return slots[slots.astype(np.uint64) < (1 << bits)]


def alive_set_words(keys: np.ndarray, alive: np.ndarray, meta: np.ndarray,
                    bits: int) -> np.ndarray:
    """The dense bitmap's ``uint32`` words (``bitmap_num_words(bits)``) of
    a set's host copy, one bit for each of its alive slots: what a
    snapshot and ``state_to_numpy`` carry, so a set-backed state reads as
    the bitmap the dense path would have left."""
    words = np.zeros(bitmap_num_words(bits), np.uint32)
    _set_bits(words, alive_set_slots(keys, alive, meta, bits).astype(np.int64),
              True)
    return words


def alive_slots(words: np.ndarray) -> np.ndarray:
    """The slots whose bits are set in dense ``uint32`` words, ascending."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    nz = np.flatnonzero(words)
    bitrows = np.unpackbits(words[nz].view(np.uint8), bitorder="little")
    row, col = np.nonzero(bitrows.reshape(-1, 32))
    return (nz[row].astype(np.uint32) << np.uint32(5)) | col.astype(np.uint32)
