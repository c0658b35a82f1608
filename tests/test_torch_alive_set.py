"""The exact alive set (kafka_topic_analyzer_tpu_torch/ops/alive_set.py,
backends/alive.py): a hash set keyed by the full u32 slot that stands in
for the dense alive bitmap on the single-device backend.

Its numpy twins are held, bit for bit, against the dense bitmap's pair
apply over seeded pair sequences: the alive count and the words built on
the host from the set's entries.  At 2^32 slots the dense side is a few
space shards of the bitmap (the whole is 512 MiB), the shards that hold
slots 0, 5, 5 | 2^31 and 0xFFFFFFFF.  Then the backend: its grows, its
switch to the dense bitmap at the threshold, snapshots through a
set-backed state, the resident bytes it books, and the counters; its
grow, staged through the host in chunks, against one rehash of the whole
table.  The ``cuda``-marked twins run the kernels on a card and skip
here; one of them holds the grow to one table on the card at a time and
to no wait for the stream.
"""

import gc
import time

import numpy as np
import pytest
import torch

from kafka_topic_analyzer_tpu_torch.backends import alive as alive_mod
from kafka_topic_analyzer_tpu_torch.backends.alive import READBACKS, AliveTable
from kafka_topic_analyzer_tpu_torch.backends.base import resident_bytes_live
from kafka_topic_analyzer_tpu_torch.backends.cpu import CpuExactBackend
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.engine import run_scan
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
from kafka_topic_analyzer_tpu_torch.models.state import (
    AliveBitmapState,
    AliveSetState,
    state_nbytes,
)
from kafka_topic_analyzer_tpu_torch.obs import metrics as obs_metrics
from kafka_topic_analyzer_tpu_torch.obs.registry import default_registry
from kafka_topic_analyzer_tpu_torch.ops import alive_set as als
from kafka_topic_analyzer_tpu_torch.ops.bitmap import (
    bitmap_apply_pairs,
    bitmap_apply_pairs_plain,
    bitmap_num_words,
)

from port_instruments import PORT_ONLY

#: Slots every sequence starts with: the ends of the u32 range and two
#: slots that differ only in bit 31.
SPECIAL = (0, 0xFFFFFFFF, 5, 5 | 1 << 31)
#: At 2^32 slots, the dense side's space shards (of 4,096, 2^20 slots
#: each): those of slots 0 and 5, 5 | 2^31, and 0xFFFFFFFF.
SHARDS, SHARD_INDEXES = 4096, (0, 2048, 4095)


def pair_table(slots, flags, t: int, device="cpu"):
    slot = np.zeros(t, np.uint32)
    flag = np.zeros(t, np.uint8)
    slot[: len(slots)] = slots
    flag[: len(flags)] = flags
    return (torch.from_numpy(slot.view(np.int32)).to(device),
            torch.from_numpy(flag).to(device),
            torch.tensor(len(slots), dtype=torch.int32, device=device))


def sequence(seed: int, bits: int, applies: int = 14):
    """Seeded applies of distinct slots each: the special slots set in the
    first, flipped in the second and cleared later; clears of slots never
    set; slots re-set and re-cleared in successive applies; at 2^24 slots
    most draws fall past the span."""
    rng = np.random.default_rng(seed)
    pool = np.unique(np.concatenate([
        rng.integers(0, 1 << 32, size=3000, dtype=np.uint64),
        # Dense near the shards' slots, so their words see many bits.
        rng.integers(0, 1 << 20, size=800, dtype=np.uint64),
        (1 << 31) + rng.integers(0, 1 << 20, size=800, dtype=np.uint64),
        (1 << 32) - 1 - rng.integers(0, 1 << 20, size=800, dtype=np.uint64),
    ]).astype(np.uint32))
    pool = pool[~np.isin(pool, SPECIAL)]
    never = pool[:200]  # cleared, never set
    pool = pool[200:]
    out = []
    for step in range(applies):
        n = int(rng.integers(1, 600))
        slots = rng.choice(pool, size=n, replace=False)
        flags = rng.integers(0, 2, size=n).astype(np.uint8)
        if step in (0, 1, 9):
            flip = {0: 1, 1: 0, 9: 0}[step]
            slots = np.concatenate([np.array(SPECIAL, np.uint32), slots])
            flags = np.concatenate([np.full(4, flip, np.uint8), flags])
        if step % 3 == 2:
            slots = np.concatenate([slots, never[step * 10:step * 10 + 10]])
            flags = np.concatenate([flags, np.zeros(10, np.uint8)])
        if step >= 1 and step % 2:
            # The previous apply's slots again, each flag flipped.
            prev_s, prev_f = out[-1]
            keep = ~np.isin(prev_s, slots)
            slots = np.concatenate([slots, prev_s[keep]])
            flags = np.concatenate([flags, 1 - prev_f[keep]])
        out.append((slots, flags))
    return out


def shard_words(slots: np.ndarray, index: int) -> np.ndarray:
    """Space shard ``index``'s words (of `SHARDS` at 2^32 slots) with a
    bit for each of ``slots`` inside it."""
    w = bitmap_num_words(32, SHARDS)
    base = index * w * 32
    inside = slots[(slots >= base) & (slots < base + w * 32)].astype(np.int64) - base
    words = np.zeros(w, np.uint32)
    np.bitwise_or.at(words, inside >> 5, np.left_shift(np.uint32(1), (inside & 31).astype(np.uint32)))
    return words


class Dense:
    """The dense path: the whole bitmap below 2^32 slots, its shards in
    `SHARD_INDEXES` at 2^32, on ``device``."""

    def __init__(self, bits: int, device="cpu"):
        self.bits = bits
        self.shards = SHARDS if bits == 32 else 1
        idx = SHARD_INDEXES if bits == 32 else (0,)
        w = bitmap_num_words(bits, self.shards)
        self.words = {i: torch.zeros(w, dtype=torch.int32, device=device) for i in idx}

    def apply(self, slot, flag, n, kernel=False):
        fn = bitmap_apply_pairs if kernel else bitmap_apply_pairs_plain
        for i, words in self.words.items():
            fn(words, slot, flag, n, self.bits, i, self.shards)

    def host(self) -> dict:
        return {i: w.cpu().numpy().view(np.uint32) for i, w in self.words.items()}


def set_words(st: AliveSetState) -> dict:
    """The set's words, built on the host: the whole bitmap, or the dense
    side's shards at 2^32 slots."""
    host = [t.cpu().numpy() for t in (st.keys, st.alive, st.meta)]
    if st.bits < 32:
        return {0: als.alive_set_words(*host, st.bits)}
    slots = als.alive_set_slots(*host, st.bits)
    return {i: shard_words(slots, i) for i in SHARD_INDEXES}


def replay_alive(seq, bits: int, upto: int) -> int:
    """The alive count: the last flag each slot below 2^bits received."""
    last = {}
    for slots, flags in seq[:upto]:
        for s, f in zip(slots.tolist(), flags.tolist()):
            if s < 1 << bits:
                last[s] = f
    return sum(last.values())


def run_sequence(seq, bits: int, device: str, grow_at: int, kernel=False):
    """Apply ``seq`` to a set (growing it before apply ``grow_at``) and to
    the dense path; after every apply compare the count and the words."""
    st = AliveSetState.empty(1 << 12, bits, device)
    dense = Dense(bits, device)
    for step, (slots, flags) in enumerate(seq):
        if step == grow_at:
            grown = AliveSetState.empty(st.capacity * 4, bits, device)
            als.alive_set_rehash(st.keys, st.alive, grown.keys, grown.alive)
            grown.meta.copy_(st.meta)
            st = grown
        slot, flag, n = pair_table(slots, flags, len(slots) + 37, device)
        als.alive_set_apply(st.keys, st.alive, st.meta, slot, flag, n, bits)
        dense.apply(slot, flag, n, kernel)
        got, want = set_words(st), dense.host()
        for i in want:
            np.testing.assert_array_equal(got[i], want[i], err_msg=f"apply {step}, shard {i}")
        count, entries, full = als.alive_set_count(st.alive, st.meta).tolist()
        assert count == replay_alive(seq, bits, step + 1)
        assert full == 0
        if bits < 32:
            assert count == int(np.bitwise_count(want[0]).sum())
    return st


def entries(st: AliveSetState) -> dict:
    """The set's entries, on the host: slot → its alive bit."""
    keys = st.keys.cpu().numpy().view(np.uint32)
    bits = st.alive.cpu().numpy().view(np.uint32)
    idx = np.flatnonzero(keys != als.EMPTY)
    on = (bits[idx >> 5] >> (idx & 31).astype(np.uint32)) & 1
    return dict(zip(keys[idx].tolist(), on.tolist()))


def holder(alive) -> object:
    """What `AliveTable` sizes: an object with an ``alive`` sub-state."""
    st = type("S", (), {})()
    st.alive = alive
    return st


@pytest.mark.parametrize("bits", [32, 24])
@pytest.mark.parametrize("seed", range(6))
def test_plain_set_equals_the_dense_bitmap_over_seeded_sequences(seed, bits):
    st = run_sequence(sequence(seed, bits), bits, "cpu", grow_at=7)
    # Entries: every slot ever set below the span, less slot 0xFFFFFFFF,
    # which has its own cell.
    seq = sequence(seed, bits)
    ever = {s for slots, flags in seq for s, f in zip(slots.tolist(), flags.tolist())
            if f and s < 1 << bits and s != 0xFFFFFFFF}
    assert int(st.meta[als.ENTRIES]) == len(ever)


def test_slots_that_differ_in_bit_31_count_apart_at_2_32_and_not_past_the_span():
    """At 2^32 slots, 5 and 5 | 2^31 are two keys; a 2^31-slot set drops
    the second (a slot past its span), as a 2^31-slot bitmap does."""
    for bits, want in ((32, 3), (31, 1)):
        st = AliveSetState.empty(1 << 12, bits, "cpu")
        slot, flag, n = pair_table([5, 5 | 1 << 31, 0xFFFFFFFF], [1, 1, 1], 8)
        als.alive_set_apply(st.keys, st.alive, st.meta, slot, flag, n, bits)
        assert als.alive_set_count(st.alive, st.meta).tolist()[0] == want
    # The top slot takes no entry: its bit lives in meta.
    assert int(st.meta[als.ENTRIES]) == 1
    clear = pair_table([0xFFFFFFFF, 7], [0, 0], 4)
    st = AliveSetState.empty(1 << 12, 32, "cpu")
    als.alive_set_apply(st.keys, st.alive, st.meta, slot, flag, n, 32)
    als.alive_set_apply(st.keys, st.alive, st.meta, *clear, 32)
    # A clear of an absent slot inserts nothing.
    assert als.alive_set_count(st.alive, st.meta).tolist()[:2] == [2, 2]


@pytest.mark.parametrize("bits", [24, 21])
def test_both_alive_forms_give_one_answer_through_one_surface(bits):
    """The set and the dense bitmap take pairs, give their words and count
    through the same methods, and agree after every apply."""
    cfg = config(bits)
    forms = (AliveSetState.empty(1 << 12, bits, "cpu"),
             AliveBitmapState.init(cfg, "cpu"))
    seq = sequence(3, bits)
    for step, (slots, flags) in enumerate(seq):
        pairs = pair_table(slots, flags, len(slots) + 5)
        for alive in forms:
            alive.apply_pairs(*pairs, cfg)
        got, want = (alive.host_words() for alive in forms)
        np.testing.assert_array_equal(got, want, err_msg=f"apply {step}")
        assert forms[0].count() == forms[1].count() == replay_alive(seq, bits, step + 1)


def test_capacity_for_holds_the_count_at_half_and_the_bound_at_three_quarters():
    assert als.capacity_for(1 << 16, 0, 0) == 1 << 16
    assert als.capacity_for(1 << 16, 1 << 15, 1 << 15) == 1 << 16
    assert als.capacity_for(1 << 16, (1 << 15) + 1, 0) == 1 << 17
    assert als.capacity_for(1 << 16, 0, 3 << 14) == 1 << 16
    assert als.capacity_for(1 << 16, 0, (3 << 14) + 1) == 1 << 17
    assert als.capacity_for(1 << 16, 10, 262_144) == 1 << 19
    assert als.capacity_limit(32) == 1 << 25 and als.capacity_limit(23) == 1 << 16
    assert als.set_nbytes(1 << 24) == 64 * 2**20 + 2 * 2**20 + 16


def test_alive_slots_reads_every_set_bit():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 32, size=1 << 10, dtype=np.uint64).astype(np.uint32)
    words[::3] = 0
    words[-1] |= 0x80000000
    slots = als.alive_slots(words)
    assert slots.size == int(np.bitwise_count(words).sum())
    rebuilt = np.zeros_like(words)
    np.bitwise_or.at(rebuilt, slots >> 5, np.left_shift(np.uint32(1), slots & 31))
    np.testing.assert_array_equal(rebuilt, words)
    assert slots[-1] == (words.size << 5) - 1


# -- the backend --------------------------------------------------------------


def config(bits: int, **kw) -> AnalyzerConfig:
    return AnalyzerConfig(num_partitions=2, batch_size=kw.pop("batch_size", 4096),
                          count_alive_keys=True, alive_bitmap_bits=bits, **kw)


def spec(keys: int, messages: int = 60_000, seed: int = 11) -> SyntheticSpec:
    return SyntheticSpec(num_partitions=2, messages_per_partition=messages,
                         keys_per_partition=keys, tombstone_permille=150, seed=seed)


def oracle_alive(cfg, sp) -> int:
    return run_scan("t", SyntheticSource(sp), CpuExactBackend(cfg), cfg.batch_size
                    ).metrics.alive_keys


def counter(name: str, **labels) -> float:
    snap = default_registry().snapshot()
    for sample in snap[name]["samples"]:
        if sample.get("labels", {}) == labels:
            return sample["value"]
    return 0.0


@pytest.fixture(autouse=True)
def _reset():
    default_registry().reset()
    yield
    default_registry().reset()


@pytest.mark.parametrize("form", ["compacted", "compaction off", "superbatch"])
def test_backend_grows_its_set_with_the_distinct_slots_seen(form):
    kw = {"compaction off": dict(alive_compaction="off"),
          "superbatch": {}}.get(form, {})
    from kafka_topic_analyzer_tpu_torch.config import DispatchConfig

    cfg = config(32, **kw)
    sp = spec(keys=60_000)
    dispatch = DispatchConfig(superbatch=3) if form == "superbatch" else None
    backend = TorchBackend(cfg, init_now_s=10**10, device="cpu", dispatch=dispatch)
    before = state_nbytes(backend.state)["alive"]
    assert isinstance(backend.state.alive, AliveSetState)
    assert before == als.set_nbytes(als.MIN_CAPACITY)
    result = run_scan("t", SyntheticSource(sp), backend, cfg.batch_size)
    alive = backend.state.alive
    assert isinstance(alive, AliveSetState)
    assert result.metrics.alive_keys == oracle_alive(cfg, sp)
    entries = int(alive.meta[als.ENTRIES])
    # Grown to what was inserted: at most 3/4 full after the last apply (at
    # most half full before it, by the count read then), and doubled only
    # past half: at least a quarter full.
    assert alive.capacity > als.MIN_CAPACITY
    assert 4 * entries <= 3 * alive.capacity <= 12 * entries
    assert counter("kta_alive_set_grows_total") >= 1
    assert counter("kta_alive_set_entries") == entries
    assert counter("kta_alive_dense_conversions_total") == 0
    # The booking follows the grows: what is booked is what the state holds.
    booked = counter("kta_device_resident_bytes_total", owner="alive")
    assert booked == state_nbytes(backend.state)["alive"] == als.set_nbytes(alive.capacity)
    assert counter("kta_device_resident_bytes_max") >= sum(state_nbytes(backend.state).values())


def test_backend_switches_to_the_dense_bitmap_at_the_threshold():
    """At 2^23 slots a set may hold 2^16 entries (a quarter of the
    bitmap's 1 MiB): past 2^15 distinct slots the backend switches to the
    bitmap, once, and the answer stays exact."""
    cfg = config(23)
    sp = spec(keys=30_000)
    gc.collect()
    live0 = resident_bytes_live()
    backend = TorchBackend(cfg, init_now_s=10**10, device="cpu")
    assert isinstance(backend.state.alive, AliveSetState)
    result = run_scan("t", SyntheticSource(sp), backend, cfg.batch_size)
    assert isinstance(backend.state.alive, AliveBitmapState)
    assert result.metrics.alive_keys == oracle_alive(cfg, sp)
    assert counter("kta_alive_dense_conversions_total") == 1
    assert counter("kta_alive_set_grows_total") == 0
    dense = (1 << 23) // 8
    assert counter("kta_device_resident_bytes_total", owner="alive") == dense
    assert resident_bytes_live() == live0 + sum(state_nbytes(backend.state).values())
    backend.close()
    assert resident_bytes_live() == live0


def test_the_mask_form_and_small_bitmaps_start_dense():
    # 2^22 slots: a set could not grow past 2^15 entries, under its start.
    assert isinstance(TorchBackend(config(22), device="cpu").state.alive, AliveBitmapState)
    # 2^24 slots with a 2^16-record table: the set/clear masks (4 MiB) are
    # the dispatch's form.
    mask = TorchBackend(config(24, batch_size=1 << 16), device="cpu")
    assert isinstance(mask.state.alive, AliveBitmapState)
    assert isinstance(TorchBackend(config(24), device="cpu").state.alive, AliveSetState)


def test_close_takes_the_grown_set_off_the_live_sum():
    """A batch fleet closes each topic's backend when its pass ends: the
    set's current bytes, after its grows, leave the live sum."""
    cfg = config(32)
    gc.collect()
    live0 = resident_bytes_live()
    backend = TorchBackend(cfg, init_now_s=10**10, device="cpu")
    run_scan("t", SyntheticSource(spec(keys=60_000)), backend, cfg.batch_size)
    held = sum(state_nbytes(backend.state).values())
    assert backend.state.alive.capacity > als.MIN_CAPACITY
    assert resident_bytes_live() == live0 + held
    backend.close()
    assert resident_bytes_live() == live0
    backend.close()
    assert resident_bytes_live() == live0


@pytest.mark.parametrize("bits, keys, cut", [(24, 3_000, 6), (23, 40_000, 16)])
def test_snapshot_round_trips_through_a_set_backed_backend(tmp_path, bits, keys, cut):
    """get_state → snapshot → set_state into a fresh (set-backed) backend
    gives the same alive words, and the resumed scan ends where a straight
    one does.  At 2^23 slots a set may hold 2^16 entries; the second
    snapshot's alive slots pass half that, and the resumed backend takes
    the dense bitmap."""
    from kafka_topic_analyzer_tpu_torch import checkpoint

    cfg = config(bits)
    sp = spec(keys=keys, messages=40_000)
    first = TorchBackend(cfg, init_now_s=10**10, device="cpu")
    for i, batch in enumerate(SyntheticSource(sp).batches(cfg.batch_size)):
        if i == cut:
            break
        first.update(batch)
    leaves = first.get_state()
    want_set = keys == 3_000
    assert (int(np.bitwise_count(leaves["alive.words"]).sum()) * 2
            <= als.capacity_limit(bits)) == want_set
    checkpoint.save_snapshot(str(tmp_path), "t", cfg, leaves, {0: 1, 1: 1}, 1, 10**10)
    loaded, *_ = checkpoint.load_snapshot(str(tmp_path), "t", cfg)
    second = TorchBackend(cfg, init_now_s=10**10, device="cpu")
    second.set_state(loaded)
    got = second.get_state()
    np.testing.assert_array_equal(got["alive.words"], leaves["alive.words"])
    assert isinstance(second.state.alive, AliveSetState) == want_set
    assert isinstance(first.state.alive, AliveSetState) == want_set
    # One switch in each backend that passed the limit.
    assert counter("kta_alive_dense_conversions_total") == (0 if want_set else 2)
    for i, batch in enumerate(SyntheticSource(sp).batches(cfg.batch_size)):
        if i >= cut:
            first.update(batch)
            second.update(batch)
    assert second.finalize().alive_keys == first.finalize().alive_keys == \
        oracle_alive(cfg, sp)
    np.testing.assert_array_equal(second.get_state()["alive.words"],
                                  first.get_state()["alive.words"])


def test_set_state_refuses_words_of_another_size():
    backend = TorchBackend(config(24), device="cpu")
    leaves = backend.get_state()
    leaves["alive.words"] = leaves["alive.words"][:-1]
    with pytest.raises(ValueError, match="alive.words"):
        backend.set_state(leaves)


class FakeEvent:
    """``torch.cuda.Event``'s surface for `AliveTable`, completed when the
    test says so; waiting on it fails the test."""
    done = False

    def record(self, stream=None):
        pass

    def query(self):
        return FakeEvent.done

    def synchronize(self):
        raise AssertionError("a fold waited for the set's count")


def test_reserve_reads_counts_without_waiting(monkeypatch):
    """The count read back is used once its copy has completed, never
    waited for; until then the bound (count + pairs sent since) sizes the
    set, and no more than `READBACKS` reads are in flight."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    cfg = config(32)
    table = AliveTable(cfg, torch.device("cpu"), 4096)
    table._host = torch.zeros(READBACKS, dtype=torch.int32)  # as on a card
    st = type("S", (), {})()
    st.alive = table.init()
    FakeEvent.done = False
    for _ in range(6):
        table.reserve(st, 10_000)
        st.alive.meta[als.ENTRIES] += 1_000  # what the device inserted
        table.counted(st)
    # Six applies of 10,000 pairs, no count read: 60,000 bound at most
    # 3/4 of the table.
    assert st.alive.capacity == 1 << 17 and len(table._inflight) == READBACKS
    FakeEvent.done = True
    table.reserve(st, 10_000)
    # Read: 4,000 entries after the fourth apply, 70,000 - 40,000 pairs since.
    assert (table._entries, table._pairs - table._pairs_at) == (4_000, 30_000)
    assert st.alive.capacity == 1 << 17


@pytest.mark.parametrize("chunk", [32, 1 << 10, 1 << 13, 1 << 15])
def test_a_staged_grow_leaves_what_one_rehash_of_the_table_leaves(chunk, monkeypatch):
    """A grow rehashes the old table back in chunks of `GROW_CHUNK`
    entries, each an old table of its own.  Below, at and above the old
    table's 2^13 entries, it leaves the slots, the bit of each, the meta
    and the count that one rehash of the whole table leaves: cleared
    entries and slot 0xFFFFFFFF's own bit included."""
    monkeypatch.setattr(alive_mod, "GROW_CHUNK", chunk)
    old = AliveSetState.empty(1 << 13, 32, "cpu")
    top = (np.array([0xFFFFFFFF], np.uint32), np.ones(1, np.uint8))
    for slots, flags in sequence(5, 32) + [top]:
        als.alive_set_apply(old.keys, old.alive, old.meta,
                            *pair_table(slots, flags, len(slots)), 32)
    held = entries(old)
    assert set(held.values()) == {0, 1} and int(old.meta[als.TOP_BIT]) == 1
    assert 4 * len(held) <= 3 * old.capacity and int(old.meta[als.FULL]) == 0
    want = AliveSetState.empty(1 << 15, 32, "cpu")
    als.alive_set_rehash_plain(old.keys, old.alive, want.keys, want.alive)
    want.meta.copy_(old.meta)
    st = holder(old)
    AliveTable(config(32), torch.device("cpu"), 4096)._grow(st, 1 << 15)
    assert st.alive.capacity == 1 << 15
    assert entries(st.alive) == entries(want) == held
    assert torch.equal(st.alive.meta, want.meta)
    assert als.alive_set_count(st.alive.alive, st.alive.meta).tolist() == \
        als.alive_set_count(want.alive, want.meta).tolist()
    assert counter("kta_alive_grow_staged_bytes_total") == \
        old.keys.nbytes + old.alive.nbytes


def test_grows_through_reserve_keep_the_dense_answer_and_book_the_staged_bytes(
        monkeypatch):
    """Driven by `AliveTable.reserve`, a 2^26-slot set grows more than
    once in chunks of 2^12 entries, gives the dense bitmap's words and
    count after every apply, and books each old table's keys and bits on
    ``kta_alive_grow_staged_bytes_total``."""
    monkeypatch.setattr(alive_mod, "GROW_CHUNK", 1 << 12)
    bits = 26
    table = AliveTable(config(bits), torch.device("cpu"), 4096)
    st = holder(table.init())
    dense = Dense(bits)
    rng = np.random.default_rng(26)
    seen = np.zeros(0, np.uint32)
    olds = []
    for step in range(6):
        fresh = rng.integers(0, 1 << bits, size=30_000, dtype=np.uint64)
        again = seen[rng.random(seen.size) < 0.3]
        slots = np.unique(np.concatenate([fresh.astype(np.uint32), again]))
        # A fifth cleared: some of them present, some never set.
        flags = (rng.random(slots.size) < 0.8).astype(np.uint8)
        capacity = st.alive.capacity
        table.reserve(st, slots.size)
        if st.alive.capacity != capacity:
            olds.append(capacity)
        pairs = pair_table(slots, flags, slots.size + 7)
        st.alive.apply_pairs(*pairs, table.config)
        table.counted(st)
        dense.apply(*pairs)
        want = dense.host()[0]
        np.testing.assert_array_equal(st.alive.host_words(), want, err_msg=f"apply {step}")
        assert st.alive.count() == int(np.bitwise_count(want).sum())
        seen = np.union1d(seen, slots)
    assert len(olds) >= 2 and counter("kta_alive_set_grows_total") == len(olds)
    assert counter("kta_alive_grow_staged_bytes_total") == sum(
        als.set_nbytes(c) - 4 * als.META_WORDS for c in olds)


def test_the_set_counters_are_in_metrics_and_port_only():
    from kafka_topic_analyzer_tpu_torch.obs.registry import render_prometheus

    cfg = config(32)
    backend = TorchBackend(cfg, init_now_s=10**10, device="cpu")
    run_scan("t", SyntheticSource(spec(keys=60_000)), backend, cfg.batch_size)
    # What /metrics serves (obs/exporters.py renders the registry's snapshot).
    text = render_prometheus(default_registry().snapshot())
    for name, kind in (("kta_alive_set_entries", "gauge"),
                       ("kta_alive_set_grows_total", "counter"),
                       ("kta_alive_dense_conversions_total", "counter"),
                       ("kta_alive_grow_seconds_total", "counter"),
                       ("kta_alive_grow_staged_bytes_total", "counter"),
                       ("kta_alive_switch_seconds_total", "counter"),
                       ("kta_alive_dense_pairs_total", "counter")):
        assert f"# TYPE {name} {kind}" in text
        assert PORT_ONLY[name] == (kind, ())
    assert obs_metrics.ALIVE_SET_ENTRIES.value == int(backend.state.alive.meta[als.ENTRIES])


# -- on a card ----------------------------------------------------------------


#: The set's kernels, each with its ``launches`` counter.
LAUNCHED = (als.alive_set_apply, als.alive_set_rehash, als.alive_set_count)


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the alive set's kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [32, 24])
@pytest.mark.parametrize("seed", range(3))
def test_cuda_kernels_equal_the_dense_bitmap_over_seeded_sequences(seed, bits):
    cuda_or_skip()
    before = {fn: fn.launches for fn in LAUNCHED}
    seq = sequence(seed, bits)
    card = run_sequence(seq, bits, "cuda", grow_at=7, kernel=True)
    # One apply and one count an apply, one rehash for the grow.
    assert {fn: fn.launches - before[fn] for fn in LAUNCHED} == {
        als.alive_set_apply: len(seq), als.alive_set_rehash: 1,
        als.alive_set_count: len(seq)}
    twin = run_sequence(seq, bits, "cpu", grow_at=7)
    assert als.alive_set_count(card.alive, card.meta).tolist() == \
        als.alive_set_count(twin.alive, twin.meta).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("bits, keys, dense", [(32, 60_000, False), (23, 30_000, True)])
def test_cuda_backend_grows_or_switches_and_equals_the_host(bits, keys, dense):
    cuda_or_skip()
    cfg = config(bits)
    sp = spec(keys=keys)
    words, counts = {}, {}
    for device in ("cuda", "cpu"):
        backend = TorchBackend(cfg, init_now_s=10**10, device=device)
        before = {fn: fn.launches for fn in LAUNCHED}
        grows = obs_metrics.ALIVE_SET_GROWS.value
        result = run_scan("t", SyntheticSource(sp), backend, cfg.batch_size)
        assert isinstance(backend.state.alive, AliveBitmapState) == dense
        if device == "cuda":
            # Every grow (of a table of at most `GROW_CHUNK` entries here)
            # is one rehash launch; the one finalize counts a set with one
            # launch, and the dense bitmap with none.
            assert als.alive_set_rehash.launches - before[als.alive_set_rehash] \
                == obs_metrics.ALIVE_SET_GROWS.value - grows
            assert als.alive_set_count.launches - before[als.alive_set_count] \
                == int(not dense)
        counts[device] = result.metrics.alive_keys
        words[device] = backend.get_state()["alive.words"] if bits < 32 else None
        backend.close()
    assert counts["cuda"] == counts["cpu"] == oracle_alive(cfg, sp)
    if bits < 32:
        np.testing.assert_array_equal(words["cuda"], words["cpu"])


#: Cycles of a device spin of about 0.1 s at an H100's clocks
#: (``torch.cuda._sleep``).
SPIN_CYCLES = 200_000_000


@pytest.mark.cuda
def test_cuda_grow_holds_one_table_at_a_time_and_never_waits_for_the_stream():
    """A 2^22-entry set holding 2^21 slots (a fifth cleared) grows to 2^23
    entries.  The allocator's peak rises over the bytes live before by at
    most the new table less the old one, one staging chunk and 1 MiB, so
    the two tables were never on the card together; the grow returns
    while a spin queued before it still runs; the grown set equals the
    host's rehash of the same table."""
    cuda_or_skip()
    table = AliveTable(config(32), torch.device("cuda"), 4096)
    # A first grow builds the kernel and the host allocator's first buffers.
    st = holder(AliveSetState.empty(1 << 16, 32, "cuda"))
    table._grow(st, 1 << 17)
    rng = np.random.default_rng(2026)
    slots = np.unique(rng.integers(0, 1 << 32, size=(1 << 21) + (1 << 16),
                                   dtype=np.uint64).astype(np.uint32))
    slots = rng.permutation(slots[slots != als.EMPTY])[:1 << 21]
    st = holder(AliveSetState.empty(1 << 22, 32, "cuda"))
    for flags in (np.ones(slots.size, np.uint8),
                  (rng.random(slots.size) < 0.8).astype(np.uint8)):
        st.alive.apply_pairs(*pair_table(slots, flags, slots.size, "cuda"),
                             table.config)
    host = AliveSetState(keys=st.alive.keys.cpu(), alive=st.alive.alive.cpu(),
                         meta=st.alive.meta.cpu(), bits=32)
    assert len(entries(host)) == 1 << 21
    want = AliveSetState.empty(1 << 23, 32, "cpu")
    als.alive_set_rehash_plain(host.keys, host.alive, want.keys, want.alive)
    want.meta.copy_(host.meta)

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda._sleep(SPIN_CYCLES)
    spun = torch.cuda.Event()
    spun.record()
    t0 = time.perf_counter()
    table._grow(st, 1 << 23)
    held = time.perf_counter() - t0
    ahead = not spun.query()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before

    chunk = als.set_nbytes(alive_mod.GROW_CHUNK) - 4 * als.META_WORDS
    assert rise <= als.set_nbytes(1 << 23) - als.set_nbytes(1 << 22) + chunk + (1 << 20)
    assert ahead and held < 0.05, f"the grow held the host {held:.4f} s"
    assert entries(st.alive) == entries(want)
    assert st.alive.meta.tolist() == want.meta.tolist()
    assert als.alive_set_count(st.alive.alive, st.alive.meta).tolist() == \
        als.alive_set_count(want.alive, want.meta).tolist()
