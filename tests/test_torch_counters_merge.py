"""The port's counter-table merge (kafka_topic_analyzer_tpu_torch/ops/
counters_merge.py) against the reference's Pallas ``_merge_kernel``, run
through ``pallas_counters_merge(..., interpret=True)``.

Comparisons are exact: the merge is an integer add, and both sides wrap
modulo 2^64 (the TPU kernel through its u32/i32 digit carry, the port in
native int64).  The CUDA kernel itself runs only on a card; its test is
marked ``cuda`` and skips here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_topic_analyzer_tpu.ops.pallas_counters import pallas_counters_merge
from kafka_topic_analyzer_tpu_torch.ops.counters_merge import (
    counters_merge,
    counters_merge_plain,
)

I64_MAX = np.iinfo(np.int64).max


def tables(p: int, seed: int):
    """Random tables plus the TPU kernel's hard cases: low digits that
    carry into the high digit, sums at and past I64_MAX, negatives, and
    zeros."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-(1 << 62), 1 << 62, size=(p, 7), dtype=np.int64)
    d = rng.integers(-(1 << 40), 1 << 40, size=(p, 7), dtype=np.int64)
    a[:, 0], d[:, 0] = 0xFFFFFFFF, rng.integers(1, 1 << 33, size=p)
    a[:, 1], d[:, 1] = I64_MAX - 3, 3
    a[:, 2], d[:, 2] = I64_MAX, 1
    a[:, 3], d[:, 3] = 0, 0
    a[:, 4], d[:, 4] = -1, 1
    return a, d


@pytest.mark.parametrize("p", [1, 3, 16, 300])
def test_plain_and_cpu_wrapper_match_interpreted_pallas_kernel(p):
    a, d = tables(p, seed=p)
    want = np.asarray(
        pallas_counters_merge(jnp.asarray(a), jnp.asarray(d), interpret=True)
    )
    plain = counters_merge_plain(torch.from_numpy(a), torch.from_numpy(d))
    np.testing.assert_array_equal(plain.numpy(), want)
    acc = torch.from_numpy(a.copy())
    before = counters_merge.launches
    out = counters_merge(acc, torch.from_numpy(d))
    assert out is acc  # in place
    np.testing.assert_array_equal(acc.numpy(), want)
    assert counters_merge.launches == before  # the CPU path launches nothing


def test_carry_and_wrap_cases_by_hand():
    a = torch.tensor([[0xFFFFFFFF, I64_MAX, 0, -1, 5, 0, 1 << 40]], dtype=torch.int64)
    d = torch.tensor([[1, 1, 0, 1, -7, 0, 1 << 40]], dtype=torch.int64)
    counters_merge(a, d)
    assert a.tolist() == [[1 << 32, -(1 << 63), 0, 0, -2, 0, 1 << 41]]


@pytest.mark.parametrize(
    "acc, delta, err",
    [
        (torch.zeros(2, 7, dtype=torch.int32), torch.zeros(2, 7, dtype=torch.int32), TypeError),
        (torch.zeros(2, 6, dtype=torch.int64), torch.zeros(2, 6, dtype=torch.int64), ValueError),
        (torch.zeros(2, 7, dtype=torch.int64), torch.zeros(3, 7, dtype=torch.int64), ValueError),
        (torch.zeros(7, 2, dtype=torch.int64).t(), torch.zeros(2, 7, dtype=torch.int64), ValueError),
        (torch.zeros(2, 7, dtype=torch.int64, device="meta"),
         torch.zeros(2, 7, dtype=torch.int64, device="meta"), ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(acc, delta, err):
    with pytest.raises(err):
        counters_merge(acc, delta)


def jax_step_sums(d, size0, count0):
    """The JAX step's global sums for one delta table
    (kafka_topic_analyzer_tpu/backends/step.py:227-228)."""
    delta = jnp.asarray(d)
    size = jnp.int64(size0) + jnp.sum(delta[:, 5] + delta[:, 6])
    count = jnp.int64(count0) + jnp.sum(delta[:, 0])
    return int(size), int(count)


def sum_tables(p: int, seed: int):
    """`tables` whose byte columns sum past I64_MAX, so the global sums
    wrap, with starting scalars near the int64 limits."""
    a, d = tables(p, seed)
    rng = np.random.default_rng(seed + 1000)
    d[:, 5] = rng.integers(1 << 61, 1 << 62, size=p)
    d[:, 6] = I64_MAX - rng.integers(0, 1 << 20, size=p)
    return a, d, I64_MAX - 5, -(1 << 63) + 7


@pytest.mark.parametrize("p", [1, 3, 16, 300])
def test_plain_and_cpu_wrapper_global_sums_match_jax_step(p):
    a, d, size0, count0 = sum_tables(p, seed=p)
    want_table = np.asarray(
        pallas_counters_merge(jnp.asarray(a), jnp.asarray(d), interpret=True)
    )
    want_sums = jax_step_sums(d, size0, count0)
    size = torch.tensor(size0, dtype=torch.int64)
    count = torch.tensor(count0, dtype=torch.int64)
    plain = counters_merge_plain(
        torch.from_numpy(a), torch.from_numpy(d),
        overall_size=size, overall_count=count,
    )
    np.testing.assert_array_equal(plain.numpy(), want_table)
    assert (int(size), int(count)) == want_sums
    acc = torch.from_numpy(a.copy())
    size = torch.tensor(size0, dtype=torch.int64)
    count = torch.tensor(count0, dtype=torch.int64)
    before = counters_merge.launches
    out = counters_merge(
        acc, torch.from_numpy(d), overall_size=size, overall_count=count
    )
    assert out is acc
    np.testing.assert_array_equal(acc.numpy(), want_table)
    assert (int(size), int(count)) == want_sums
    assert counters_merge.launches == before


def test_global_sums_wrap_past_i64_max():
    d = np.zeros((2, 7), dtype=np.int64)
    d[:, 5] = I64_MAX
    d[:, 6] = 1
    d[:, 0] = 3
    size = torch.tensor(1, dtype=torch.int64)
    count = torch.tensor(I64_MAX, dtype=torch.int64)
    counters_merge(torch.zeros(2, 7, dtype=torch.int64), torch.from_numpy(d),
                   overall_size=size, overall_count=count)
    # 1 + 2 * (I64_MAX + 1) = 1 mod 2^64; I64_MAX + 6 wraps negative.
    assert (int(size), int(count)) == jax_step_sums(d, 1, I64_MAX)
    assert (int(size), int(count)) == (1, -(1 << 63) + 5)


def _scalars():
    return torch.zeros((), dtype=torch.int64), torch.zeros((), dtype=torch.int64)


@pytest.mark.parametrize(
    "size, count, err",
    [
        (torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int64), TypeError),
        (torch.zeros((), dtype=torch.int64), torch.zeros((), dtype=torch.float64), TypeError),
        (torch.zeros(1, dtype=torch.int64), torch.zeros((), dtype=torch.int64), ValueError),
        (torch.zeros((), dtype=torch.int64), torch.zeros(2, 1, dtype=torch.int64), ValueError),
        (torch.zeros((), dtype=torch.int64, device="meta"),
         torch.zeros((), dtype=torch.int64), ValueError),
        (torch.zeros((), dtype=torch.int64), None, ValueError),
        (None, torch.zeros((), dtype=torch.int64), ValueError),
        (0, torch.zeros((), dtype=torch.int64), TypeError),
    ],
    ids=["size-dtype", "count-dtype", "size-shape", "count-shape",
         "size-device", "count-missing", "size-missing", "size-not-a-tensor"],
)
def test_wrapper_refuses_a_scalar_the_kernel_does_not_take(size, count, err):
    acc = torch.zeros(2, 7, dtype=torch.int64)
    with pytest.raises(err):
        counters_merge(acc, torch.ones(2, 7, dtype=torch.int64),
                       overall_size=size, overall_count=count)
    assert acc.abs().sum() == 0  # refused before any add


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On a card: the kernel against its plain version at the slice's
    partition counts, launch counted once per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for p in (1, 16, 300, 32767):
        a, d = tables(p, seed=p)
        acc = torch.from_numpy(a).cuda()
        delta = torch.from_numpy(d).cuda()
        want = counters_merge_plain(acc, delta)
        before = counters_merge.launches
        counters_merge(acc, delta)
        torch.cuda.synchronize()
        assert counters_merge.launches == before + 1
        assert torch.equal(acc, want)


@pytest.mark.cuda
def test_cuda_kernel_global_sums_match_plain_version():
    """On a card: the launch with the global sums against the plain
    version, one launch per call, sums wrapping past I64_MAX."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for p in (1, 16, 300, 32767):
        a, d, size0, count0 = sum_tables(p, seed=p)
        acc = torch.from_numpy(a).cuda()
        delta = torch.from_numpy(d).cuda()
        want_size = torch.tensor(size0, dtype=torch.int64, device="cuda")
        want_count = torch.tensor(count0, dtype=torch.int64, device="cuda")
        want = counters_merge_plain(
            acc, delta, overall_size=want_size, overall_count=want_count
        )
        size, count = want_size.new_tensor(size0), want_count.new_tensor(count0)
        before = counters_merge.launches
        counters_merge(acc, delta, overall_size=size, overall_count=count)
        torch.cuda.synchronize()
        assert counters_merge.launches == before + 1
        assert torch.equal(acc, want)
        assert (int(size), int(count)) == (int(want_size), int(want_count))
        assert (int(size), int(count)) == jax_step_sums(d, size0, count0)
