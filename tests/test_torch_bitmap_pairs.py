"""The alive bitmap's pair apply (kafka_topic_analyzer_tpu_torch/ops/
bitmap.py): the plain version against the reference's ``bitmap_apply_pairs``
on the CPU, and the CUDA kernel (``csrc/bitmap_pairs.cu``) against the plain
version on a card.

Comparisons are exact: each pair sets or clears one bit.  Slots within one
apply are distinct, as the host's last-writer-wins dedupe leaves them.  The
reference is imported inside the CPU test, so the card's tests (marked
``cuda``, skipped here) run without JAX.
"""

import numpy as np
import pytest
import torch

from kafka_topic_analyzer_tpu_torch.ops.bitmap import (
    bitmap_apply_pairs,
    bitmap_apply_pairs_plain,
    bitmap_num_words,
)


def distinct_slots(rng, lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` distinct u32 slots in ``[lo, hi)``, in random order."""
    out = np.unique(rng.integers(lo, hi, size=2 * n + 8, dtype=np.uint64))
    rng.shuffle(out)
    return out[:n].astype(np.uint32)


def table(slots, flags, t: int, pad_slot: int = 0):
    """A pair table of capacity ``t``: the live prefix, then padding
    entries (slot ``pad_slot``, flag 0 past the prefix)."""
    slot = np.full(t, pad_slot, dtype=np.uint32)
    flag = np.zeros(t, dtype=np.uint8)
    slot[: len(slots)] = slots
    flag[: len(flags)] = flags
    return slot, flag


def random_rounds(rng, bits: int, t: int, lo: int = 0, hi: "int | None" = None):
    hi = (1 << bits) if hi is None else hi
    rounds = []
    for _ in range(2):
        slots = distinct_slots(rng, lo, hi, t)
        rounds.append(table(slots, rng.integers(0, 2, size=t), t) + (t,))
    return rounds


def case_random_2_18(rng):
    return 18, 1, random_rounds(rng, 18, 4096)


def case_random_2_32(rng):
    """2^32 bits: the top of 4,096 space shards (slots at and near
    0xFFFFFFFF, negative as int32) beside slots spread over the whole u32
    range, which fall outside the shard."""
    s = 4096
    lo = (s - 1) * bitmap_num_words(32, s) * 32
    rounds = []
    for _ in range(2):
        inside = distinct_slots(rng, lo, 1 << 32, 3000)
        spread = distinct_slots(rng, 0, lo, 1000)
        slots = np.concatenate([inside, spread, [0xFFFFFFFF]])
        slots = np.unique(slots)
        rng.shuffle(slots)
        rounds.append(table(slots, rng.integers(0, 2, size=len(slots)), 4200)
                      + (len(slots),))
    return 32, s, rounds


def case_bit_31(rng):
    """Bit 31 of every word (``INT32_MIN``), set and cleared, beside bit 0."""
    words = np.arange(1 << 5, dtype=np.uint64)
    b31 = (words * 32 + 31).astype(np.uint32)
    b0 = (words * 32).astype(np.uint32)
    rounds = []
    for flip in (0, 1):
        flags = (np.arange(32) + flip) % 2
        slots = np.concatenate([b31, b0[::3]])
        fl = np.concatenate([flags, 1 - flags[::3]])
        rounds.append(table(slots, fl, 64) + (len(slots),))
    return 10, 1, rounds


def case_one_word(rng):
    """All 32 bits of one word in one apply, sets and clears mixed, then
    every bit of two neighbouring words."""
    w = 7 * 32
    r1 = rng.permutation(np.arange(w, w + 32, dtype=np.uint32))
    r2 = rng.permutation(np.arange(w - 32, w + 32, dtype=np.uint32))
    return 12, 1, [
        table(r1, rng.integers(0, 2, size=32), 40) + (32,),
        table(r2, rng.integers(0, 2, size=64), 64) + (64,),
    ]


def case_n_pairs(rng):
    """``n_pairs`` 0, partial and full over one table: entries past the
    live prefix hold slots and flags that must change nothing."""
    slots = distinct_slots(rng, 0, 1 << 14, 512)
    flags = rng.integers(0, 2, size=512)
    slot, flag = table(slots, flags, 512)
    return 14, 1, [(slot, flag, 0), (slot, flag, 200), (slot, flag, 512)]


def case_padding(rng):
    """The packer's padding (slot 0, flag 0) behind a short prefix, with a
    live pair on slot 0's word: padding must not clear it."""
    slots = np.concatenate([[1, 31], distinct_slots(rng, 32, 1 << 16, 100)])
    flags = np.concatenate([[1, 1], rng.integers(0, 2, size=100)])
    return 16, 1, [table(slots, flags, 1024) + (len(slots),),
                   table([0], [1], 8) + (1,)]


def case_shards(s: int):
    def case(rng):
        rounds = []
        for _ in range(2):
            slots = distinct_slots(rng, 0, 1 << 16, 3000)
            # Slots on each shard's edges.
            edges = np.arange(s, dtype=np.uint32) * ((1 << 16) // s)
            slots = np.unique(np.concatenate([slots, edges, np.maximum(edges, 1) - 1]))
            rng.shuffle(slots)
            rounds.append(table(slots, rng.integers(0, 2, size=len(slots)), 3200)
                          + (len(slots),))
        return 16, s, rounds
    return case


CASES = {
    "random-2^18": case_random_2_18,
    "random-2^32": case_random_2_32,
    "bit-31": case_bit_31,
    "one-word": case_one_word,
    "n_pairs-0-partial-full": case_n_pairs,
    "padding": case_padding,
    "space-shards-1": case_shards(1),
    "space-shards-2": case_shards(2),
    "space-shards-4": case_shards(4),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_the_reference(name):
    from jax import numpy as jnp

    from kafka_topic_analyzer_tpu.ops.bitmap import bitmap_apply_pairs as ref_apply

    rng = np.random.default_rng(sum(map(ord, name)))
    bits, s, rounds = CASES[name](rng)
    w = bitmap_num_words(bits, s)
    launches = bitmap_apply_pairs.launches
    # The top shard only at 2^32 bits (the others are 3 GiB of words).
    for idx in ([s - 1] if bits == 32 else range(s)):
        start = rng.integers(0, 1 << 32, size=w, dtype=np.uint64).astype(np.uint32)
        ref = jnp.asarray(start)
        words = torch.from_numpy(start.view(np.int32).copy())
        for slot, flag, n in rounds:
            ref = ref_apply(ref, jnp.asarray(slot), jnp.asarray(flag), jnp.int32(n),
                            bits, space_index=idx, space_shards=s)
            got = bitmap_apply_pairs(
                words, torch.from_numpy(slot.view(np.int32)), torch.from_numpy(flag),
                torch.tensor(n, dtype=torch.int32), bits, space_index=idx,
                space_shards=s,
            )
            assert got is words
            np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                          np.asarray(ref), err_msg=f"shard {idx}")
    assert bitmap_apply_pairs.launches == launches  # CPU tensors never launch


def args(bits: int = 10, t: int = 8):
    return (torch.zeros(bitmap_num_words(bits), dtype=torch.int32),
            torch.zeros(t, dtype=torch.int32), torch.zeros(t, dtype=torch.uint8),
            torch.tensor(t, dtype=torch.int32))


REFUSALS = {
    "int64 words": (lambda a: (a[0].long(),) + a[1:], TypeError, "int32 words"),
    "uint32-as-int64 slots": (lambda a: (a[0], a[1].long()) + a[2:], TypeError,
                              "int32 slots"),
    "bool flags": (lambda a: a[:2] + (a[2].bool(), a[3]), TypeError, "uint8 flags"),
    "int64 n_pairs": (lambda a: a[:3] + (a[3].long(),), TypeError, "int32 n_pairs"),
    "words of another size": (lambda a: (a[0][:-1],) + a[1:], ValueError, "words for"),
    "flags shorter than slots": (lambda a: a[:2] + (a[2][:-1], a[3]), ValueError,
                                 "one length"),
    "2-d slots": (lambda a: (a[0], a[1].view(2, -1), a[2].view(2, -1), a[3]),
                  ValueError, "1-d slots"),
    "n_pairs of two values": (lambda a: a[:3] + (a[3].repeat(2),), ValueError,
                              "one value"),
    "strided slots": (lambda a: (a[0], torch.zeros(16, dtype=torch.int32)[::2],
                                 a[2], a[3]), ValueError, "contiguous"),
    "words on the meta device": (lambda a: (a[0].to("meta"),) + a[1:], ValueError,
                                 "device mismatch"),
    "a list of slots": (lambda a: (a[0], [0] * 8) + a[2:], TypeError, "takes tensors"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refuses_what_the_kernel_does_not_take(name):
    change, error, match = REFUSALS[name]
    with pytest.raises(error, match=match):
        bitmap_apply_pairs(*change(args()), 10)


def test_refuses_a_space_index_outside_the_shards():
    words, slot, flag, n = args(bits=12)
    with pytest.raises(ValueError, match="space_index 4 outside 4"):
        bitmap_apply_pairs(words[: bitmap_num_words(12, 4)], slot, flag, n, 12,
                           space_index=4, space_shards=4)


# ---------------------------------------------------------------------------
# on the card


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the pair kernel has no CPU mode)")


#: The demo cell's bitmap: 2^32 slots.
DEMO_BITS = 32


def demo_tables(rng, t: int, base: int):
    """Pair tables of capacity ``t``: random slots over 2^32 with a full
    prefix; clustered slots (every bit of ``t / 32`` consecutive words
    from slot ``base`` on, so 32 pairs meet on each word); a partial
    prefix behind which the padding holds random slots."""
    def flags():
        return rng.integers(0, 2, size=t).astype(np.uint8)

    clustered = np.uint32(base) + rng.permutation(t).astype(np.uint32)
    return {
        "random": (distinct_slots(rng, 0, 1 << 32, t), flags(), t),
        "clustered": (clustered, flags(), t),
        "partial": (distinct_slots(rng, 0, 1 << 32, t), flags(), t * 5 // 8),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("space_shards", [1, 4])
@pytest.mark.parametrize("t", [1 << 16, 1 << 18])
def test_cuda_kernel_matches_plain_version_at_the_demos_shapes(t, space_shards):
    """At 2^32 slots, tables of 65,536 entries and of 262,144 (the demo
    audit's: one 2^18-record row of distinct keys a dispatch)."""
    cuda_or_skip()
    rng = np.random.default_rng(20261018 + space_shards + t)
    w = bitmap_num_words(DEMO_BITS, space_shards)
    idx = space_shards - 1
    words = torch.randint(-(1 << 31), 1 << 31, (w,), dtype=torch.int32, device="cuda")
    want = words.clone()
    base = idx * w * 32 + (123_456_789 & ~31)  # inside the shard
    for label, (slot, flag, n) in demo_tables(rng, t, base).items():
        slot_t = torch.from_numpy(slot.view(np.int32)).cuda()
        flag_t = torch.from_numpy(flag).cuda()
        n_t = torch.tensor(n, dtype=torch.int32, device="cuda")
        launches = bitmap_apply_pairs.launches
        bitmap_apply_pairs(words, slot_t, flag_t, n_t, DEMO_BITS, space_index=idx,
                           space_shards=space_shards)
        # The plain version is plain PyTorch: run it on the card's tensors.
        bitmap_apply_pairs_plain(want, slot_t, flag_t, n_t, DEMO_BITS, idx,
                                 space_shards)
        torch.cuda.synchronize()
        assert bitmap_apply_pairs.launches == launches + 1
        assert torch.equal(words, want), label


@pytest.mark.cuda
def test_cuda_kernel_on_a_stacked_shards_view_writes_that_shard_only():
    """A mesh's stacked state: the kernel on row 1's view of ``[S, W]``
    words leaves the other rows as they were."""
    cuda_or_skip()
    rng = np.random.default_rng(7)
    bits, s = 20, 4
    w = bitmap_num_words(bits, s)
    stack = torch.randint(-(1 << 31), 1 << 31, (s, w), dtype=torch.int32, device="cuda")
    want = stack.clone()
    slot, flag = table(distinct_slots(rng, 0, 1 << bits, 4000),
                       rng.integers(0, 2, size=4000), 4096)
    args_ = (torch.from_numpy(slot.view(np.int32)).cuda(), torch.from_numpy(flag).cuda(),
             torch.tensor(4000, dtype=torch.int32, device="cuda"))
    bitmap_apply_pairs(stack[1], *args_, bits, space_index=1, space_shards=s)
    bitmap_apply_pairs_plain(want[1], *args_, bits, 1, s)
    torch.cuda.synchronize()
    assert torch.equal(stack, want)


SCAN_PATHS = {
    "compacted": {},
    "compaction off": {"alive_compaction": "off"},
    "v4 compaction off": {"alive_compaction": "off", "wire_format": 4},
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(SCAN_PATHS))
def test_cuda_scan_launches_once_per_dispatch_with_a_pair_list(path):
    """A scan on the card launches the kernel once per dispatch that
    carries a pair list (a compacted table in its list form, or a row's
    own pairs), and leaves the bitmap the host's scan leaves.  At 2^22
    slots the backend holds the dense bitmap (an exact set may not pass a
    quarter of its bytes, ``ops/alive_set.capacity_limit``), and a
    4096-record table is a list."""
    cuda_or_skip()
    from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
    from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
    from kafka_topic_analyzer_tpu_torch.engine import run_scan
    from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec
    from kafka_topic_analyzer_tpu_torch.models.state import state_to_numpy
    from kafka_topic_analyzer_tpu_torch.packing import alive_table_mode, pair_table_capacity

    cfg = AnalyzerConfig(num_partitions=3, batch_size=4096, count_alive_keys=True,
                         alive_bitmap_bits=22, **SCAN_PATHS[path])
    if cfg.compact_alive:
        assert alive_table_mode(cfg, pair_table_capacity(cfg, 4096, 1)) == 1
    spec = SyntheticSpec(num_partitions=3, messages_per_partition=20_000,
                         keys_per_partition=500, tombstone_permille=150, seed=3)
    words = {}
    for device in ("cuda", "cpu"):
        backend = TorchBackend(cfg, init_now_s=10**10, device=device)
        bitmap_apply_pairs.launches = 0
        result = run_scan("t", SyntheticSource(spec), backend, 4096)
        words[device] = state_to_numpy(backend.state)["alive.words"]
        if device == "cuda":
            assert bitmap_apply_pairs.launches == backend.dispatches > 0
            alive = result.metrics.alive_keys
        else:
            assert bitmap_apply_pairs.launches == 0
            assert result.metrics.alive_keys == alive
    np.testing.assert_array_equal(words["cuda"], words["cpu"])
