"""The port's wire-v5 step (``analyzer_step_v5`` + ``apply_pair_table``)
against the reference's (``analyzer_step`` on v5 rows +
``apply_pair_table``, with ``use_pallas_counters`` — the Pallas merge
kernel in interpret mode on the CPU).

Each case starts both sides from the same non-trivial state: a reference
state carried into the port with ``state_from_numpy``.  After every batch
the port's state, read back with ``state_to_numpy``, must equal the
reference's leaf for leaf.  Comparisons are exact: every fold is an
integer reduction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_topic_analyzer_tpu import packing as ref_packing
from kafka_topic_analyzer_tpu.backends.step import analyzer_step
from kafka_topic_analyzer_tpu.backends.step import apply_pair_table as ref_apply_pair_table
from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefConfig
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSource as RefSource
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSpec as RefSpec
from kafka_topic_analyzer_tpu.models.state import AnalyzerState as RefState
from kafka_topic_analyzer_tpu.ops.bitmap import bitmap_apply_pairs as ref_apply_pairs
from kafka_topic_analyzer_tpu.records import RecordBatch as RefBatch
from kafka_topic_analyzer_tpu_torch import packing
from kafka_topic_analyzer_tpu_torch.backends.step import analyzer_step_v5, apply_pair_table
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.models.state import (
    AnalyzerState,
    state_from_numpy,
    state_to_numpy,
)
from kafka_topic_analyzer_tpu_torch.ops.bitmap import bitmap_apply_pairs, bitmap_scratch
from kafka_topic_analyzer_tpu_torch.records import RecordBatch

CASES = {
    "masks_hll-table_quant-global": dict(
        batch_size=1024, enable_hll=True, hll_p=10, enable_quantiles=True,
        alive_bitmap_bits=18),
    "pair-list_hll-flat-pairs_quant-pp": dict(
        batch_size=1024, distinct_keys_per_partition=True, hll_p=12,
        quantiles_per_partition=True, alive_bitmap_bits=24),
    "odd-batch_hll-u16-pairs": dict(
        batch_size=777, enable_hll=True, hll_p=16, alive_bitmap_bits=24),
}


def jax_leaves(state) -> "dict[str, np.ndarray]":
    """A reference state as the port's leaf-path dict."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(state))
    return {jax.tree_util.keystr(path).lstrip("."): np.array(leaf)
            for path, leaf in flat}


def assert_same_leaves(port_state, ref_state):
    got, want = state_to_numpy(port_state), jax_leaves(ref_state)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_v5_step_matches_reference_from_a_carried_state(case):
    kw = {"num_partitions": 3, "count_alive_keys": True,
          "use_pallas_counters": True, **CASES[case]}
    ref_cfg, cfg = RefConfig(**kw), AnalyzerConfig(**kw)
    b = cfg.batch_size
    cap = packing.pair_table_capacity(cfg, b)
    spec = RefSpec(num_partitions=3, messages_per_partition=900,
                   keys_per_partition=60, tombstone_permille=300, seed=3)
    batches = list(RefSource(spec).batches(b))
    # Warm the reference state on the first batch, carry it over, then
    # step both sides through the rest (a partial tail) and an empty batch.
    ref_state = RefState.init(ref_cfg)

    def ref_step(st, batch):
        row = ref_packing.pack_batch(batch, ref_cfg, use_native=False)
        pairs, _, _ = ref_packing.pack_pair_table(
            [ref_packing.batch_alive_pairs(batch, ref_cfg, use_native=False)],
            ref_cfg, cap, use_native=False,
        )
        st = analyzer_step(st, ref_packing.unpack_device(jnp.asarray(row), ref_cfg), ref_cfg)
        return ref_apply_pair_table(
            st, ref_packing.unpack_pair_table_device(jnp.asarray(pairs), ref_cfg, cap),
            ref_cfg,
        )

    ref_state = ref_step(ref_state, batches[0])
    state = state_from_numpy(jax_leaves(ref_state), device="cpu")
    assert_same_leaves(state, ref_state)
    scratch = (
        bitmap_scratch(cfg.alive_bitmap_bits, "cpu")
        if packing.alive_table_mode(cfg, cap) == 1 else None
    )
    for batch in batches[1:] + [RefBatch.empty(0)]:
        port_batch = RecordBatch(**batch.as_dict())
        row = packing.pack_batch(port_batch, cfg)
        pairs, _, _ = packing.pack_pair_table(
            [packing.batch_alive_pairs(port_batch, cfg)], cfg, cap
        )
        analyzer_step_v5(state, packing.unpack_device(torch.from_numpy(row), cfg), cfg)
        apply_pair_table(
            state, packing.unpack_pair_table_device(torch.from_numpy(pairs), cfg, cap),
            cfg, scratch=scratch,
        )
        ref_state = ref_step(ref_state, batch)
        assert_same_leaves(state, ref_state)
    if scratch is not None:
        assert not scratch.any()  # every apply re-zeroed what it touched


def test_state_round_trips_through_numpy_leaves():
    kw = dict(num_partitions=2, count_alive_keys=True, alive_bitmap_bits=12,
              distinct_keys_per_partition=True, hll_p=6,
              quantiles_per_partition=True)
    ref_state = RefState.init(RefConfig(**kw))
    assert_same_leaves(AnalyzerState.init(AnalyzerConfig(**kw), "cpu"), ref_state)
    leaves = jax_leaves(ref_state)
    leaves["alive.words"][3] = 0x80000001  # bit 31 survives the int32 view
    back = state_to_numpy(state_from_numpy(leaves, device="cpu"))
    for name in leaves:
        np.testing.assert_array_equal(back[name], leaves[name], err_msg=name)


def test_pair_apply_sets_and_clears_bits_31_and_0_of_one_word():
    """Bit 31 is INT32_MIN in the port's int32 words: set and clear it
    beside bit 0 of the same word (and of a second word), against the
    reference's uint32 apply."""
    bits = 8
    ref_words = jnp.zeros(8, dtype=jnp.uint32)
    words = torch.zeros(8, dtype=torch.int32)
    scratch = bitmap_scratch(bits, "cpu")
    rounds = [
        ([31, 0, 63, 32, 200], [1, 1, 1, 1, 1], 4),  # last pair is padding
        ([31, 63, 5], [0, 1, 1], 3),
        ([0, 32, 31], [0, 0, 1], 3),
        ([], [], 0),
    ]
    for slots, flags, n in rounds:
        slot = np.zeros(6, dtype=np.uint32)
        flag = np.zeros(6, dtype=np.uint8)
        slot[: len(slots)], flag[: len(flags)] = slots, flags
        ref_words = ref_apply_pairs(
            ref_words, jnp.asarray(slot), jnp.asarray(flag), jnp.int32(n), bits
        )
        bitmap_apply_pairs(
            words, torch.from_numpy(slot.view(np.int32)), torch.from_numpy(flag),
            torch.tensor(n, dtype=torch.int32), bits, scratch=scratch,
        )
        np.testing.assert_array_equal(
            words.numpy().view(np.uint32), np.asarray(ref_words)
        )
    assert words.numpy().view(np.uint32)[0] == (1 << 31) | (1 << 5)
