"""The single-device backend's alive state: an exact set sized by the
distinct slots seen (``ops/alive_set.py``), or the dense bitmap where that
is smaller or required.

The choice reads only what the backend observes: the bitmap's ``2^bits``
slots, the pair table's form, and the set's inserted count.

- A backend starts with a set of `alive_set.MIN_CAPACITY` entries, unless
  the dense bitmap is no larger than a set may grow (`capacity_limit`:
  keys at most a quarter of the bitmap's bytes, so no set below 2^23
  slots) or the dispatch's pair table takes the set/clear mask form,
  which merges into dense words.
- Before each apply (`reserve`) the host sizes the set from two counts:
  the entries it last read back from the device, and an upper bound on
  the entries after this apply, that count plus every live pair sent
  since it was read.  The set doubles, by a rehash on the backend's
  stream, until the count read is at a load of at most 1/2 and the bound
  at most 3/4 (`capacity_for`), so no apply can fill it.  The count comes
  back without a wait: after each apply a 4-byte asynchronous copy to
  pinned memory and an event (`counted`), read once the event has
  completed.  The bound keeps a count read a few folds late safe, and the
  count keeps the grows to what was inserted rather than what was sent:
  the demo topic sends 16M pairs for its 8M keys.
- When the set would grow past `capacity_limit`, the backend switches to
  the dense bitmap for good: the set is copied to the host and freed, the
  bitmap is allocated, and the alive slots go back in pair-list chunks
  through `bitmap_apply_pairs`, so the two are never held at once.
- A grow never holds the old table and the new one on the device at
  once.  The old keys and bits are copied to pinned host memory (on the
  host, the CPU tensors themselves) and dropped, the new table is
  allocated, and the old entries come back in chunks of `GROW_CHUNK`
  through one device staging pair, each chunk rehashed into the new
  table as an old table of its own.  All of it is enqueued on the
  backend's stream, where the old table was allocated and used, so the
  caching allocator hands its freed blocks only to later work there;
  the host waits for nothing, and torch's host allocator keeps a pinned
  buffer until the copies that use it have run.

Every grow and the switch add the bytes the state gained to the backend's
resident booking (``kta_device_resident_bytes_total{owner="alive"}`` and
the live sum behind ``kta_device_resident_bytes_max``), which its close
takes off whole; they are counted on ``kta_alive_set_grows_total`` and
``kta_alive_dense_conversions_total``, a grow's old keys and bits on
``kta_alive_grow_staged_bytes_total``, and each count read sets
``kta_alive_set_entries``.  Each grow is span ``alive-grow`` (``from`` and
``to`` capacity in its args; ``kta_alive_grow_seconds_total``: the host's
enqueue, the copies and rehashes run on the stream after) around its
phases ``stage`` (the pinned buffers' allocation and the copy to them)
and ``reinsert`` (the chunks' copies and rehash launches, after the new
table's allocation), each switch span ``alive-switch``
(``kta_alive_switch_seconds_total``) around its phases ``copy`` (the set
to the host, which waits for the stream), ``slots`` (its alive slots, on
the host) and ``load`` (their chunks into the bitmap).  ``kta_alive_dense_pairs_total`` counts the pairs a dense
bitmap takes through `bitmap_apply_pairs`: each compacted pair list's and
the switch's loaded slots.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from kafka_topic_analyzer_tpu_torch._torch_support import u32_to_i32
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.models.state import (
    AliveBitmapState,
    AliveSetState,
    AnalyzerState,
    substate_nbytes,
)
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs import trace as obs_trace
from kafka_topic_analyzer_tpu_torch.ops.alive_set import (
    ENTRIES,
    MIN_CAPACITY,
    alive_set_rehash,
    alive_set_slots,
    alive_slots,
    capacity_for,
    capacity_limit,
    set_nbytes,
)
from kafka_topic_analyzer_tpu_torch.ops.bitmap import bitmap_num_words
from kafka_topic_analyzer_tpu_torch.packing import alive_table_mode

#: Count readbacks in flight at most (pinned 4-byte slots).
READBACKS = 4
#: Slots a pair-list chunk carries when a switch or a snapshot's load
#: puts alive slots back.
LOAD_CHUNK = 1 << 20
#: Entries of the old table a grow copies back and rehashes a launch:
#: 1 MiB of keys and 32 KiB of bits on the device beside the new table.
GROW_CHUNK = 1 << 18


def _exact(state: AnalyzerState) -> bool:
    return isinstance(state.alive, AliveSetState)


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: a pinned copy enqueued on the current stream
    for a CUDA tensor, a CPU tensor itself."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _reinsert(keys: torch.Tensor, alive: torch.Tensor, new: AliveSetState) -> None:
    """Rehash the host table ``keys``/``alive`` into the empty, larger
    ``new`` in chunks of `GROW_CHUNK` entries (a power of two of at least
    32), each an old table of its own: on a card copied into one device
    staging pair first, on the host rehashed in place."""
    step = min(GROW_CHUNK, keys.numel())
    device = new.keys.device
    stage = None
    if keys.device != device:
        stage = (torch.empty(step, dtype=keys.dtype, device=device),
                 torch.empty(step // 32, dtype=alive.dtype, device=device))
    for lo in range(0, keys.numel(), step):
        chunk = (keys[lo:lo + step], alive[lo // 32:(lo + step) // 32])
        if stage is not None:
            for dst, src in zip(stage, chunk):
                dst.copy_(src, non_blocking=True)
            chunk = stage
        alive_set_rehash(*chunk, new.keys, new.alive)


class AliveTable:
    """Sizes and switches one backend's alive state (see the module).
    Not thread-safe: the backend calls it from the thread that folds."""

    def __init__(self, config: AnalyzerConfig, device: torch.device,
                 pair_capacity: int):
        self.config = config
        self.bits = config.alive_bitmap_bits
        self.device = device
        mask_form = (config.compact_alive
                     and alive_table_mode(config, pair_capacity) == 2)
        #: Whether a new state starts as an exact set.  Afterwards the form
        #: is the state's own (`_exact`): a caller may put in a state of
        #: the dense form, as a carry from the reference does.
        self.starts_exact = (config.count_alive_keys and not mask_form
                             and capacity_limit(self.bits) >= MIN_CAPACITY)
        #: Whether each apply is a compacted pair list whose pairs the host
        #: counted: what a dense bitmap's pairs are booked from.
        self._lists = config.compact_alive and not mask_form
        #: The backend's resident booking (`base.ResidentBooking`).
        self.booking = None
        self._pairs = 0       # live pairs sent to the set, all applies
        self._entries = 0     # the set's entries at the last count read
        self._pairs_at = 0    # ``_pairs`` when that count was taken
        self._host = (torch.zeros(READBACKS, dtype=torch.int32, pin_memory=True)
                      if device.type == "cuda" else None)
        self._inflight: "collections.deque" = collections.deque()
        self._free = list(range(READBACKS))

    def init(self) -> "AliveBitmapState | AliveSetState":
        """A new backend's alive state."""
        if self.starts_exact:
            return AliveSetState.empty(MIN_CAPACITY, self.bits, self.device)
        return AliveBitmapState.init(self.config, self.device)

    def reserve(self, state: AnalyzerState, n_pairs: int) -> None:
        """Make room, on the current stream, for an apply of at most
        ``n_pairs`` live pairs: grow the set, or switch to the bitmap.
        Books the pairs a dense bitmap takes."""
        if _exact(state):
            self._make_room(state, n_pairs)
        if self._lists and isinstance(state.alive, AliveBitmapState):
            obs_metrics.ALIVE_DENSE_PAIRS.inc(n_pairs)

    def _make_room(self, state: AnalyzerState, n_pairs: int) -> None:
        self._harvest()
        self._pairs += n_pairs
        bound = self._entries + self._pairs - self._pairs_at
        capacity = state.alive.capacity
        need = capacity_for(capacity, self._entries, bound)
        if need == capacity:
            return
        if need > capacity_limit(self.bits):
            self._to_dense(state)
        else:
            self._grow(state, need)

    def counted(self, state: AnalyzerState) -> None:
        """After an apply: start reading the set's entry count back (on
        the host the count is read at once).  With `READBACKS` reads in
        flight, none starts: a later one will."""
        if not _exact(state):
            return
        alive = state.alive
        if self._host is None:
            self._read(int(alive.meta[ENTRIES]), self._pairs)
            return
        if not self._free:
            return
        i = self._free.pop()
        self._host[i:i + 1].copy_(alive.meta[ENTRIES:ENTRIES + 1], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._inflight.append((i, event, self._pairs))

    def _harvest(self) -> None:
        """Read every count whose copy has completed (no wait)."""
        while self._inflight and self._inflight[0][1].query():
            i, _, pairs = self._inflight.popleft()
            self._read(int(self._host[i]), pairs)
            self._free.append(i)

    def _read(self, entries: int, pairs: int) -> None:
        self._entries, self._pairs_at = entries, pairs
        obs_metrics.ALIVE_SET_ENTRIES.set(entries)

    def _replace(self, state: AnalyzerState, new) -> None:
        """Put ``new`` in the state and book the bytes it adds."""
        gained = substate_nbytes(new) - substate_nbytes(state.alive)
        state.alive = new
        if self.booking is not None:
            self.booking.grow("alive", gained)

    def _grow(self, state: AnalyzerState, capacity: int) -> None:
        """Rehash the set into ``capacity`` entries through the host, so
        the old table leaves the device before the new one is allocated
        (see the module)."""
        old = state.alive
        gained = set_nbytes(capacity) - substate_nbytes(old)
        with obs_trace.timed("alive-grow", obs_metrics.ALIVE_GROW_SECONDS,
                             **{"from": old.capacity, "to": capacity}):
            with obs_trace.timed("stage"):
                keys, alive = _staged(old.keys), _staged(old.alive)
            meta = old.meta
            state.alive = old = None
            new = AliveSetState.empty(capacity, self.bits, self.device)
            new.meta.copy_(meta)
            with obs_trace.timed("reinsert"):
                _reinsert(keys, alive, new)
            state.alive = new
            if self.booking is not None:
                self.booking.grow("alive", gained)
        obs_metrics.ALIVE_SET_GROWS.inc()
        obs_metrics.ALIVE_GROW_STAGED_BYTES.inc(keys.nbytes + alive.nbytes)

    def _to_dense(self, state: AnalyzerState, slots=None) -> None:
        """Switch to the dense bitmap holding the set's alive slots (or
        ``slots``, a snapshot's), never holding both on the device."""
        with obs_trace.timed("alive-switch", obs_metrics.ALIVE_SWITCH_SECONDS):
            old = state.alive
            if slots is None:
                with obs_trace.timed("copy"):
                    host = [t.cpu().numpy() for t in (old.keys, old.alive, old.meta)]
                with obs_trace.timed("slots"):
                    slots = alive_set_slots(*host, self.bits)
            gained = -substate_nbytes(old)
            state.alive = old = None
            dense = AliveBitmapState.init(self.config, self.device)
            with obs_trace.timed("load"):
                self._load(dense, slots)
            state.alive = dense
            if self.booking is not None:
                self.booking.grow("alive", gained + substate_nbytes(dense))
            self._forget_reads()
        obs_metrics.ALIVE_DENSE_CONVERSIONS.inc()
        obs_metrics.ALIVE_DENSE_PAIRS.inc(slots.size)

    def _forget_reads(self) -> None:
        """Drop the count reads in flight (the stream has passed them)."""
        self._inflight.clear()
        self._free = list(range(READBACKS))

    def _load(self, alive, slots: np.ndarray) -> None:
        """Set ``slots`` (alive, distinct) in ``alive``, a set with room
        for them or the dense bitmap, in pair-list chunks."""
        for lo in range(0, slots.size, LOAD_CHUNK):
            chunk = slots[lo:lo + LOAD_CHUNK]
            slot = torch.from_numpy(chunk.view(np.int32)).to(self.device)
            flag = torch.ones(chunk.size, dtype=torch.uint8, device=self.device)
            n = torch.tensor(chunk.size, dtype=torch.int32, device=self.device)
            alive.apply_pairs(slot, flag, n, self.config)

    def load(self, state: AnalyzerState, leaves: dict) -> dict:
        """Load a snapshot's alive words (``leaves["alive.words"]``) into
        the state: the dense bitmap copies them in place; a set is rebuilt
        as a set of their alive slots, or switches to the bitmap when they
        would pass `capacity_limit`.  Returns the other leaves, still to
        copy (`models.state.copy_from_numpy_`)."""
        if state.alive is None:
            return leaves
        rest = dict(leaves)
        words = rest.pop("alive.words", None)
        want = (bitmap_num_words(self.bits),)
        if words is None or np.shape(words) != want:
            raise ValueError(
                f"state leaf alive.words has shape {np.shape(words)}, the "
                f"backend's {want}"
            )
        if _exact(state):
            slots = alive_slots(words)
            need = capacity_for(state.alive.capacity, slots.size, slots.size)
            if need <= capacity_limit(self.bits):
                new = AliveSetState.empty(need, self.bits, self.device)
                self._load(new, slots)
                self._replace(state, new)
                self._forget_reads()
                # Ascending: slot 0xFFFFFFFF, which takes no entry, comes last.
                top = int(slots.size > 0 and slots[-1] == 0xFFFFFFFF)
                self._read(slots.size - top, self._pairs)
                return rest
            self._to_dense(state, slots[:0])
        state.alive.words.copy_(torch.from_numpy(u32_to_i32(words)))
        return rest

    def count(self, state: AnalyzerState) -> "int | None":
        """The alive count (`AliveSetState.count`, `AliveBitmapState.count`);
        None where the backend holds no alive keys."""
        if state.alive is None:
            return None
        count = state.alive.count()
        if _exact(state):
            # The count waited for every fold: the entries read are current.
            self._forget_reads()
            self._read(int(state.alive.meta[ENTRIES]), self._pairs)
        return count
