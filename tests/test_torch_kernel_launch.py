"""The port's one launch seam for its hand-written CUDA kernels
(`_build.Kernel`, `csrc/kta_launch.cuh`), on the CPU.

No kernel runs here: a fake library stands in for the loaded ``ctypes``
entry and returns 0, the wrong-device code or a CUDA error code, so these
tests hold what the seam does around a launch — the record it packs, the
errors it raises, the wrappers' launch counts, one bind under concurrent
first launches — and that the libraries' names cover the shared header.
"""

from __future__ import annotations

import shutil
import struct
import threading
import time

import pytest
import torch

from kafka_topic_analyzer_tpu_torch import _build
from kafka_topic_analyzer_tpu_torch.ops import bitmap, counters_merge, counters_update

STREAM = 0x5EED_0000
CUDA0 = torch.device("cuda", 0)
ILLEGAL_ADDRESS = 700  # cudaErrorIllegalAddress


class FakeEntry:
    """Stands in for a ``ctypes`` C entry: records each packed argument
    record and returns ``code``."""

    def __init__(self, code: int = 0):
        self.code = code
        self.records = []

    def __call__(self, record: bytes) -> int:
        self.records.append(record)
        return self.code


class FakeLibrary:
    def __init__(self, entry: str, code: int = 0):
        self.entry = FakeEntry(code)
        setattr(self, entry, self.entry)
        self.kta_cuda_error_string = self._error_string

    @staticmethod
    def _error_string(code: int) -> bytes:
        if code == _build.WRONG_DEVICE:
            return b"the tensors are not on the current device"
        return f"CUDA error {code}: an illegal memory access".encode()


@pytest.fixture
def fake_cuda(monkeypatch):
    """The CUDA calls the seam makes around a launch, on a CPU build."""
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: STREAM + index, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)


def fake_load(monkeypatch, entry: str, code: int = 0, calls=None):
    lib = FakeLibrary(entry, code)

    def load(name):
        if calls is not None:
            calls.append(name)
            time.sleep(0.05)  # widen the window of concurrent first binds
        return lib

    monkeypatch.setattr(_build, "load", load)
    return lib.entry


ARGS = struct.Struct("<QqQq")


def test_a_launch_packs_its_fields_the_stream_and_the_device(monkeypatch, fake_cuda):
    entry = fake_load(monkeypatch, "kta_toy")
    kernel = _build.Kernel("toy", "kta_toy", ARGS)
    kernel.launch(torch.device("cuda", 3), 0xABC, -7)
    assert [ARGS.unpack(r) for r in entry.records] == [(0xABC, -7, STREAM + 3, 3)]


def test_the_wrong_device_code_raises_a_value_error_naming_the_kernel(
        monkeypatch, fake_cuda):
    fake_load(monkeypatch, "kta_toy", code=_build.WRONG_DEVICE)
    kernel = _build.Kernel("toy", "kta_toy", ARGS)
    with pytest.raises(ValueError, match=r"^toy: the tensors are not on the "
                       r"current device \(current device cuda:1, tensors on "
                       r"cuda:0\)$"):
        kernel.launch(CUDA0, 1, 2)


def test_a_cuda_error_raises_a_runtime_error_with_its_string(monkeypatch, fake_cuda):
    fake_load(monkeypatch, "kta_toy", code=ILLEGAL_ADDRESS)
    kernel = _build.Kernel("toy", "kta_toy", ARGS)
    with pytest.raises(RuntimeError, match="^toy kernel launch failed: CUDA error "
                       "700: an illegal memory access$"):
        kernel.launch(CUDA0, 1, 2)


def test_concurrent_first_launches_bind_once(monkeypatch, fake_cuda):
    calls = []
    entry = fake_load(monkeypatch, "kta_toy", calls=calls)
    kernel = _build.Kernel("toy", "kta_toy", ARGS)
    n = 8
    start = threading.Barrier(n)
    errors = []

    def first_launch(i):
        start.wait(timeout=30)
        try:
            kernel.launch(CUDA0, i, i)
        except Exception as e:  # reported below, with the thread's index
            errors.append((i, e))

    threads = [threading.Thread(target=first_launch, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert calls == ["toy"]
    assert sorted(ARGS.unpack(r)[0] for r in entry.records) == list(range(n))


def merge_call():
    acc = torch.zeros(3, 7, dtype=torch.int64)
    delta = torch.ones(3, 7, dtype=torch.int64)
    size = torch.zeros((), dtype=torch.int64)
    count = torch.zeros((), dtype=torch.int64)
    want = (acc.data_ptr(), delta.data_ptr(), 21, size.data_ptr(),
            count.data_ptr(), 1 << 0, (1 << 5) | (1 << 6), STREAM, 0)
    return (acc, delta, size, count), {}, want


def update_call():
    table = torch.zeros(2, 7, dtype=torch.int64)
    cols = [torch.zeros(5, dtype=torch.int32) for _ in range(3)]
    cols += [torch.zeros(5, dtype=torch.bool) for _ in range(3)]
    want = (table.data_ptr(), *(c.data_ptr() for c in cols), 5, 2, 0, 0,
            STREAM, 0)
    return (table, *cols, 2), {}, want


def pairs_call():
    words = torch.zeros(bitmap.bitmap_num_words(12, 4), dtype=torch.int32)
    slot = torch.zeros(6, dtype=torch.int32)
    flag = torch.zeros(6, dtype=torch.uint8)
    n = torch.tensor(6, dtype=torch.int32)
    span = words.shape[0] * 32
    want = (words.data_ptr(), slot.data_ptr(), flag.data_ptr(), n.data_ptr(),
            6, 2 * span, span, STREAM, 0)
    return (words, slot, flag, n, 12), {"space_index": 2, "space_shards": 4}, want


WRAPPERS = {
    "counters_merge": (counters_merge, counters_merge.counters_merge,
                       "kta_counters_merge", merge_call),
    "counters_update": (counters_update, counters_update.counters_update,
                        "kta_counters_update", update_call),
    "bitmap_apply_pairs": (bitmap, bitmap.bitmap_apply_pairs,
                           "kta_bitmap_apply_pairs", pairs_call),
}


def on_the_card(monkeypatch, module):
    """Route ``module``'s wrapper to its CUDA branch with CPU tensors (their
    pointers are only packed), and unbind its kernel afterwards."""
    checked = module._check

    def check_on_the_card(*args):
        checked(*args)  # every refusal still runs
        return CUDA0

    monkeypatch.setattr(module, "_check", check_on_the_card)
    monkeypatch.setattr(module._KERNEL, "_bound", None)


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_a_wrapper_packs_its_record_and_counts_the_launch(name, monkeypatch,
                                                          fake_cuda):
    module, wrapper, entry_name, call = WRAPPERS[name]
    on_the_card(monkeypatch, module)
    entry = fake_load(monkeypatch, entry_name)
    args, kwargs, want = call()
    monkeypatch.setattr(wrapper, "launches", 5)
    assert wrapper(*args, **kwargs) is args[0]
    assert wrapper.launches == 6
    assert [module._KERNEL.args.unpack(r)
            for r in entry.records] == [want]


@pytest.mark.parametrize("code, error", [(_build.WRONG_DEVICE, ValueError),
                                         (ILLEGAL_ADDRESS, RuntimeError)],
                         ids=["wrong-device", "cuda-error"])
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_a_failed_launch_leaves_the_wrappers_count(name, code, error, monkeypatch,
                                                   fake_cuda):
    module, wrapper, entry_name, call = WRAPPERS[name]
    on_the_card(monkeypatch, module)
    entry = fake_load(monkeypatch, entry_name, code=code)
    args, kwargs, _ = call()
    monkeypatch.setattr(wrapper, "launches", 5)
    with pytest.raises(error, match=module._KERNEL.name):
        wrapper(*args, **kwargs)
    assert wrapper.launches == 5
    assert len(entry.records) == 1


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_cpu_tensors_never_load_a_library(name, monkeypatch):
    module, wrapper, _, call = WRAPPERS[name]
    monkeypatch.setattr(module._KERNEL, "_bound", None)

    def load(kernel):
        raise AssertionError(f"a CPU call loaded {kernel}")

    monkeypatch.setattr(_build, "load", load)
    args, kwargs, _ = call()
    monkeypatch.setattr(wrapper, "launches", 0)
    wrapper(*args, **kwargs)
    assert wrapper.launches == 0
    assert module._KERNEL._bound is None


def test_library_path_covers_the_shared_header(tmp_path, monkeypatch):
    pkg = tmp_path / "pkg"
    shutil.copytree(_build._PKG / "csrc", pkg / "csrc")
    monkeypatch.setattr(_build, "_PKG", pkg)
    before = {name: _build.library_path(name) for name in _build.KERNEL_SOURCES}
    header = pkg / _build.LAUNCH_HEADER
    header.write_bytes(header.read_bytes() + b"// edited\n")
    after = {name: _build.library_path(name) for name in _build.KERNEL_SOURCES}
    assert all(after[name] != before[name] for name in before)
    assert all(p.parent == _build.build_dir() for p in after.values())
    # Every source includes the header the hash covers.
    for src in _build.KERNEL_SOURCES.values():
        assert b'#include "kta_launch.cuh"' in (pkg / src).read_bytes()
