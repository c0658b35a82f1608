"""The port's numpy exact oracle (``--backend cpu``,
`backends.cpu.CpuExactBackend`) against the reference's.

The same topic goes through both CLIs' oracles: a synthetic topic, a
segment-file dump of it, and a Kafka topic served by the loopback
`fake_broker`, in wire v5 and v4 (which the oracle ignores, as the
reference does), with every sketch flag (``-c``, ``--distinct-keys``,
``--quantiles`` and their per-partition forms, ``--extremes-table``).
Reports are compared byte for byte, timing lines aside, ``Distinct keys
(exact)`` lines included.  The backend itself is compared on the same
batches, field by field.  ``--backend tpu`` on the port is the torch
backend, the reference's spelling of ``gpu``: with ``--device cpu`` it
prints the reference's ``--backend tpu`` report.  The oracle touches no
device: it never resolves one, never imports the torch backend, and
leaves CUDA uninitialised.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from fake_broker import FakeBroker
from kafka_topic_analyzer_tpu import cli as ref_cli
from kafka_topic_analyzer_tpu.backends.cpu import CpuExactBackend as RefOracle
from kafka_topic_analyzer_tpu.config import AnalyzerConfig as RefConfig
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSource as RefSynthetic
from kafka_topic_analyzer_tpu.io.synthetic import SyntheticSpec as RefSpec
from kafka_topic_analyzer_tpu_torch import cli
from kafka_topic_analyzer_tpu_torch.backends.base import make_backend
from kafka_topic_analyzer_tpu_torch.backends.cpu import CpuExactBackend
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.io.synthetic import SyntheticSource, SyntheticSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPIC = "oracle.t"
SYNTH = "partitions=3,messages=3000,keys=400,tombstones=150"
SKETCHES = {
    "all": ["-c", "--distinct-keys", "--quantiles", "--distinct-keys-per-partition",
            "--quantiles-per-partition", "--extremes-table"],
    "exact": ["-c", "--distinct-keys"],
    "per-partition": ["--distinct-keys-per-partition", "--quantiles-per-partition"],
    "none": [],
}
FORMATS = {"v5": [], "v4": ["--wire-format", "v4"]}


def drop_timing(text: str) -> str:
    return "".join(
        line for line in text.splitlines(keepends=True)
        if not line.startswith(("Scanning took:", "Estimated Msg/s:"))
    )


def rows(partition: int, n: int):
    """Kafka records whose keys are distinct across partitions, so ``-c``
    does not depend on the order in which fetches of different partitions
    arrive; one key in five null, one value in seven null."""
    return [(i, 1_600_000_000_000 + i * 1000 + partition,
             f"k{partition}-{i % 53}".encode() if i % 5 else None,
             bytes(20 + (i * 7 + partition) % 41) if i % 7 else None) for i in range(n)]


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    from kafka_topic_analyzer_tpu_torch.tools.make_segments import make_segments

    out = tmp_path_factory.mktemp("oracle") / "segs"
    spec = SyntheticSpec.from_kv(cli.parse_kv_pairs(SYNTH))
    make_segments(str(out), TOPIC, spec, use_native=False)
    return str(out)


@pytest.fixture(scope="module")
def broker():
    with FakeBroker(TOPIC, {p: rows(p, 700) for p in range(3)},
                    max_records_per_fetch=150) as b:
        yield b


@pytest.fixture
def source_args(dump, broker):
    return {
        "synthetic": ["--source", "synthetic", "--synthetic", SYNTH],
        "segfile": ["--source", "segfile", "--segment-dir", dump],
        "kafka": ["-b", f"127.0.0.1:{broker.port}"],
    }


def scan(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, drop_timing(cap.out), cap.err


@pytest.mark.parametrize("sketches", list(SKETCHES))
@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("source", ["synthetic", "segfile", "kafka"])
def test_oracle_report_equals_the_reference_oracle(source, fmt, sketches, source_args,
                                                   capsys):
    argv = ["-t", TOPIC, *source_args[source], *FORMATS[fmt], *SKETCHES[sketches],
            "--batch-size", "1024", "--backend", "cpu", "--quiet"]
    got = scan(cli.main, argv, capsys)
    want = scan(ref_cli.main, argv, capsys)
    assert got == want
    rc, out, err = got
    assert rc == 0 and err == ""
    if sketches in ("all", "exact"):
        assert "Distinct keys (exact): " in out and "Alive keys:" in out
    if sketches == "all":
        assert "  partition 2 distinct keys (exact): " in out
        assert "Per-partition extremes:" in out
    assert "(HLL est.)" not in out


@pytest.mark.parametrize("source", ["synthetic", "kafka"])
def test_backend_tpu_is_the_torch_backend(source, source_args, capsys):
    argv = ["-t", TOPIC, *source_args[source], *SKETCHES["all"], "--batch-size", "1024",
            "--quiet"]
    tpu = scan(cli.main, argv + ["--backend", "tpu", "--device", "cpu"], capsys)
    gpu = scan(cli.main, argv + ["--device", "cpu"], capsys)
    want = scan(ref_cli.main, argv + ["--backend", "tpu", "--native", "on"], capsys)
    assert tpu == gpu == want
    assert "Distinct keys (HLL est.): " in tpu[1]


def test_oracle_backend_equals_the_reference_on_the_same_batches():
    spec = dict(num_partitions=3, messages_per_partition=2000, keys_per_partition=300)
    kw = dict(num_partitions=3, batch_size=512, count_alive_keys=True,
              alive_bitmap_bits=20, enable_hll=True, distinct_keys_per_partition=True,
              enable_quantiles=True, quantiles_per_partition=True)
    port = CpuExactBackend(AnalyzerConfig(**kw), init_now_s=1_700_000_000)
    ref = RefOracle(RefConfig(**kw), init_now_s=1_700_000_000)
    for backend, source in ((port, SyntheticSource(SyntheticSpec(**spec))),
                            (ref, RefSynthetic(RefSpec(**spec)))):
        for batch in source.batches(512):
            backend.update(batch)
    got, want = port.finalize(), ref.finalize()
    for field in dataclasses.fields(got):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), field.name
        elif isinstance(a, list) and a and dataclasses.is_dataclass(a[0]):
            assert [dataclasses.asdict(x) for x in a] == \
                [dataclasses.asdict(x) for x in b], field.name
        elif dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), field.name
        else:
            assert a == b, field.name
    assert 0 < got.distinct_keys_exact <= 900
    assert all(0 < n <= 300 for n in got.distinct_keys_exact_per_partition)


def test_oracle_never_resolves_a_device(monkeypatch, capsys):
    from kafka_topic_analyzer_tpu_torch import _torch_support

    def refuse(*_a, **_k):
        raise AssertionError("the oracle resolved a device")

    monkeypatch.setattr(_torch_support, "resolve_device", refuse)
    backend = make_backend("cpu", AnalyzerConfig(num_partitions=2), device="cuda")
    assert isinstance(backend, CpuExactBackend)
    assert cli.main(["-t", TOPIC, "--source", "synthetic", "--synthetic",
                     "partitions=2,messages=300", "--backend", "cpu", "--quiet"]) == 0
    assert "Starting message consumption..." in capsys.readouterr().out


def test_oracle_run_leaves_cuda_uninitialised_and_the_torch_backend_unimported():
    code = (
        "import contextlib, io, sys, torch\n"
        "from kafka_topic_analyzer_tpu_torch import cli\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    rc = cli.main(['-t', 't', '--source', 'synthetic', '--synthetic',\n"
        "                   'partitions=2,messages=500,keys=40', '-c', '--distinct-keys',\n"
        "                   '--backend', 'cpu', '--quiet'])\n"
        "assert rc == 0, rc\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert 'kafka_topic_analyzer_tpu_torch.backends.gpu' not in sys.modules\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
