"""The port's wire-v4 counter update (kafka_topic_analyzer_tpu_torch/ops/
counters_update.py) against the reference's Pallas ``_kernel``, run
through ``pallas_counters_update(..., interpret=True)``, and against the
reference's scatter-add ``counters_update``.

Comparisons are exact: the update is an integer segment sum.  Inputs are
made with numpy from a seed and handed to both sides.  The CUDA kernel
itself runs only on a card; its test is marked ``cuda`` and skips here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_topic_analyzer_tpu.ops.counters import counters_update as ref_counters_update
from kafka_topic_analyzer_tpu.ops.pallas_counters import BLOCK, pallas_counters_update
from kafka_topic_analyzer_tpu_torch.ops.counters_update import (
    counters_update,
    counters_update_plain,
)

VALUE_CAP = (1 << 24) - 1


def inputs(b: int, p: int, seed: int, value_max: int = 3000, valid_prefix=None):
    """Record columns as the v4 unpack gives them (int32 lengths over the
    whole u16 key range, bool flags) and a non-zero starting table."""
    rng = np.random.default_rng(seed)
    valid = (
        rng.random(b) < 0.9 if valid_prefix is None
        else np.arange(b) < valid_prefix
    )
    cols = dict(
        partition=rng.integers(0, p, size=b).astype(np.int32),
        key_len=rng.integers(0, 1 << 16, size=b).astype(np.int32),
        value_len=rng.integers(0, value_max + 1, size=b).astype(np.int32),
        key_null=rng.random(b) < 0.1,
        value_null=rng.random(b) < 0.15,
        valid=valid,
    )
    table = rng.integers(-(1 << 40), 1 << 40, size=(p, 7), dtype=np.int64)
    return table, cols


def ref_args(cols):
    return [jnp.asarray(cols[k]) for k in
            ("partition", "key_len", "value_len", "key_null", "value_null", "valid")]


def references(table, cols, p):
    """(interpreted Pallas kernel, reference scatter-add) results."""
    pallas = pallas_counters_update(
        jnp.asarray(table), *ref_args(cols), p, interpret=True
    )
    plain = ref_counters_update(jnp.asarray(table), *ref_args(cols), p)
    return np.asarray(pallas), np.asarray(plain)


def port_args(cols):
    return [torch.from_numpy(cols[k]) for k in
            ("partition", "key_len", "value_len", "key_null", "value_null", "valid")]


def check_port(table, cols, p, want):
    plain = counters_update_plain(torch.from_numpy(table), *port_args(cols), p)
    np.testing.assert_array_equal(plain.numpy(), want)
    acc = torch.from_numpy(table.copy())
    before = counters_update.launches
    out = counters_update(acc, *port_args(cols), p)
    assert out is acc  # in place
    np.testing.assert_array_equal(acc.numpy(), want)
    assert counters_update.launches == before  # the CPU path launches nothing


@pytest.mark.parametrize("p", [1, 3, 16, 64, 200, 300])
def test_plain_and_cpu_wrapper_match_interpreted_pallas_kernel(p):
    b = 4 * BLOCK
    table, cols = inputs(b, p, seed=p)
    pallas, plain = references(table, cols, p)
    np.testing.assert_array_equal(pallas, plain)
    check_port(table, cols, p, pallas)


def test_exact_at_the_16_mib_value_cap():
    table, cols = inputs(BLOCK, 4, seed=9, value_max=VALUE_CAP)
    cols["value_len"][:100] = VALUE_CAP
    pallas, plain = references(table, cols, 4)
    np.testing.assert_array_equal(pallas, plain)
    check_port(table, cols, 4, pallas)


def test_invalid_tail_adds_nothing():
    """A batch's valid records are a prefix (``arange(B) < n_valid``):
    the padded tail, whatever its columns hold, must not count."""
    table, cols = inputs(2 * BLOCK, 5, seed=21, valid_prefix=1500)
    pallas, plain = references(table, cols, 5)
    np.testing.assert_array_equal(pallas, plain)
    check_port(table, cols, 5, pallas)
    head = {k: v[:1500] for k, v in cols.items()}
    head_plain = ref_counters_update(jnp.asarray(table), *ref_args(head), 5)
    np.testing.assert_array_equal(np.asarray(head_plain), pallas)


def test_values_past_the_cap_stay_exact_without_the_digit_split():
    """The reference's scatter path (no ``--pallas``) takes any int32
    length; the port's update does too."""
    table, cols = inputs(1000, 3, seed=5, value_max=(1 << 31) - 1)
    plain = ref_counters_update(jnp.asarray(table), *ref_args(cols), 3)
    check_port(table, cols, 3, np.asarray(plain))


def _ok():
    table, cols = inputs(64, 2, seed=1)
    return torch.from_numpy(table), port_args(cols)


@pytest.mark.parametrize(
    "change, err",
    [
        (lambda t, c: (t.to(torch.int32), c), TypeError),
        (lambda t, c: (t[:, :6].contiguous(), c), ValueError),
        (lambda t, c: (t, [c[0].to(torch.int64)] + c[1:]), TypeError),
        (lambda t, c: (t, c[:3] + [c[3].to(torch.uint8)] + c[4:]), TypeError),
        (lambda t, c: (t, [c[0][:10]] + c[1:]), ValueError),
        (lambda t, c: (t, c[:5] + [c[5].view(8, 8)]), ValueError),
        (lambda t, c: (t, c[:1] + [c[1].to("meta")] + c[2:]), ValueError),
        (lambda t, c: (t.to("meta"), [x.to("meta") for x in c]), ValueError),
    ],
    ids=["table-dtype", "table-shape", "column-dtype", "flag-dtype",
         "column-length", "column-rank", "device-mismatch", "meta-device"],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(change, err):
    table, cols = change(*_ok())
    with pytest.raises(err):
        counters_update(table, *cols, 2)


def test_wrapper_refuses_a_partition_count_unlike_the_table():
    table, cols = _ok()
    with pytest.raises(ValueError, match=r"\[3, 7\]"):
        counters_update(table, *cols, 3)


def test_wrapper_refuses_a_strided_column():
    table, cols = _ok()
    strided = torch.zeros(128, dtype=torch.int32)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        counters_update(table, strided, *cols[1:], 2)


I64_MAX = np.iinfo(np.int64).max


def jax_step_sums(cols, size0, count0):
    """The JAX step's global sums for one batch's columns
    (kafka_topic_analyzer_tpu/backends/step.py:331-342)."""
    partition, key_len, value_len, key_null, value_null, valid = ref_args(cols)
    kn = valid & ~key_null
    vn = valid & ~value_null
    k_bytes = jnp.where(kn, key_len, 0).astype(jnp.int64)
    v_bytes = jnp.where(vn, value_len, 0).astype(jnp.int64)
    size = jnp.int64(size0) + jnp.sum(k_bytes + v_bytes)
    count = jnp.int64(count0) + jnp.sum(valid.astype(jnp.int64))
    return int(size), int(count)


def check_port_sums(table, cols, p, want, size0, count0):
    """The plain version and the CPU wrapper with the global sums: the
    table as ``want``, the sums as the JAX step's."""
    want_sums = jax_step_sums(cols, size0, count0)
    size = torch.tensor(size0, dtype=torch.int64)
    count = torch.tensor(count0, dtype=torch.int64)
    plain = counters_update_plain(
        torch.from_numpy(table), *port_args(cols), p,
        overall_size=size, overall_count=count,
    )
    np.testing.assert_array_equal(plain.numpy(), want)
    assert (int(size), int(count)) == want_sums
    acc = torch.from_numpy(table.copy())
    size = torch.tensor(size0, dtype=torch.int64)
    count = torch.tensor(count0, dtype=torch.int64)
    before = counters_update.launches
    out = counters_update(acc, *port_args(cols), p,
                          overall_size=size, overall_count=count)
    assert out is acc
    np.testing.assert_array_equal(acc.numpy(), want)
    assert (int(size), int(count)) == want_sums
    assert counters_update.launches == before


@pytest.mark.parametrize("p", [1, 3, 16, 300])
def test_plain_and_cpu_wrapper_global_sums_match_jax_step(p):
    table, cols = inputs(4 * BLOCK, p, seed=100 + p, value_max=VALUE_CAP)
    pallas, _ = references(table, cols, p)
    check_port_sums(table, cols, p, pallas, 12345, 678)


def test_global_sums_wrap_past_i64_max():
    """Starting scalars near I64_MAX: the key and value bytes and the
    record count carry past it and wrap, as the JAX int64 sums do."""
    table, cols = inputs(2 * BLOCK, 5, seed=33, value_max=(1 << 31) - 1,
                         valid_prefix=1800)
    want = np.asarray(
        ref_counters_update(jnp.asarray(table), *ref_args(cols), 5)
    )
    check_port_sums(table, cols, 5, want, I64_MAX - 1000, I64_MAX - 10)
    size, count = jax_step_sums(cols, I64_MAX - 1000, I64_MAX - 10)
    assert size < 0 and count < 0  # both wrapped


@pytest.mark.parametrize(
    "size, count, err",
    [
        (torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int64), TypeError),
        (torch.zeros((), dtype=torch.int64), torch.zeros((), dtype=torch.bool), TypeError),
        (torch.zeros(1, dtype=torch.int64), torch.zeros((), dtype=torch.int64), ValueError),
        (torch.zeros((), dtype=torch.int64), torch.zeros(3, dtype=torch.int64), ValueError),
        (torch.zeros((), dtype=torch.int64),
         torch.zeros((), dtype=torch.int64, device="meta"), ValueError),
        (torch.zeros((), dtype=torch.int64), None, ValueError),
        (None, torch.zeros((), dtype=torch.int64), ValueError),
        (torch.zeros((), dtype=torch.int64), 7, TypeError),
    ],
    ids=["size-dtype", "count-dtype", "size-shape", "count-shape",
         "count-device", "count-missing", "size-missing", "count-not-a-tensor"],
)
def test_wrapper_refuses_a_scalar_the_kernel_does_not_take(size, count, err):
    table, cols = _ok()
    before = table.clone()
    with pytest.raises(err):
        counters_update(table, *cols, 2, overall_size=size, overall_count=count)
    assert torch.equal(table, before)  # refused before any add


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On a card: the kernel against its plain version on both of its
    paths (shared-memory histogram and global atomics), launch counted
    once per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    b = 1 << 14
    for p in (1, 16, 300, 877, 4096, 32767):
        table, cols = inputs(b, p, seed=p, value_max=VALUE_CAP, valid_prefix=b - 999)
        acc = torch.from_numpy(table).cuda()
        args = [c.cuda() for c in port_args(cols)]
        want = counters_update_plain(acc, *args, p)
        before = counters_update.launches
        counters_update(acc, *args, p)
        torch.cuda.synchronize()
        assert counters_update.launches == before + 1
        assert torch.equal(acc, want)


@pytest.mark.cuda
def test_cuda_kernel_global_sums_match_plain_version():
    """On a card: the launch with the global sums against the plain
    version on both paths, in random, round-robin and one-partition-run
    record orders, sums wrapping past I64_MAX."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    b = 1 << 14
    for p in (1, 16, 300, 877, 4096, 32767):
        table, cols = inputs(b, p, seed=p, value_max=VALUE_CAP, valid_prefix=b - 999)
        for order in ("random", "round-robin", "runs"):
            if order == "round-robin":
                cols["partition"] = (np.arange(b) % p).astype(np.int32)
            elif order == "runs":
                cols["partition"] = np.sort(cols["partition"])
            size0, count0 = I64_MAX - 1000, I64_MAX - 10
            acc = torch.from_numpy(table).cuda()
            args = [c.cuda() for c in port_args(cols)]
            want_size = torch.tensor(size0, dtype=torch.int64, device="cuda")
            want_count = torch.tensor(count0, dtype=torch.int64, device="cuda")
            want = counters_update_plain(
                acc, *args, p, overall_size=want_size, overall_count=want_count
            )
            size, count = want_size.new_tensor(size0), want_count.new_tensor(count0)
            before = counters_update.launches
            counters_update(acc, *args, p, overall_size=size, overall_count=count)
            torch.cuda.synchronize()
            assert counters_update.launches == before + 1
            assert torch.equal(acc, want), (p, order)
            assert (int(size), int(count)) == (int(want_size), int(want_count))
            assert (int(size), int(count)) == jax_step_sums(cols, size0, count0)
