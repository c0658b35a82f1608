"""The port stands alone: no module of ``kafka_topic_analyzer_tpu_torch``
(nor ``chip_smoke.py``) imports ``jax`` or the reference package, the
port runs a scan (and imports its fleet service and leases) in a process
where both are unimportable, and asking for
the GPU without one (also by default, as the state loader does) raises
instead of falling back to the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from kafka_topic_analyzer_tpu_torch import _torch_support, cli
from kafka_topic_analyzer_tpu_torch.backends.gpu import TorchBackend
from kafka_topic_analyzer_tpu_torch.config import AnalyzerConfig
from kafka_topic_analyzer_tpu_torch.models.state import (
    AnalyzerState,
    state_from_numpy,
    state_to_numpy,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "kafka_topic_analyzer_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "kafka_topic_analyzer_tpu",
                   # the test suite's own modules (its loopback brokers)
                   "tests", "conftest", "fake_broker", "fake_objstore")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_neither_jax_nor_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_port_scans_with_jax_and_the_reference_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kafka_topic_analyzer_tpu'] = None\n"
        "from kafka_topic_analyzer_tpu_torch.cli import main\n"
        "rc = main(['-t', 't', '--source', 'synthetic',\n"
        "           '--synthetic', 'partitions=2,messages=500,keys=40',\n"
        "           '-c', '--alive-bitmap-bits', '16', '--distinct-keys-per-partition',\n"
        "           '--quantiles-per-partition', '--batch-size', '256',\n"
        "           '--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        "import kafka_topic_analyzer_tpu_torch.fleet.service\n"
        "import kafka_topic_analyzer_tpu_torch.fleet.lease\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'kafka_topic_analyzer_tpu.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Alive keys:" in proc.stdout
    assert "partition 1 size quantiles:" in proc.stdout


def test_gpu_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("gpu", "cuda", None):
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            _torch_support.resolve_device(name)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        TorchBackend(AnalyzerConfig(), device="gpu")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        cli.main(["-t", "t", "--source", "synthetic", "--synthetic", "messages=10",
                  "--backend", "gpu"])
    assert _torch_support.resolve_device("cpu") == torch.device("cpu")


def test_state_loader_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    leaves = state_to_numpy(AnalyzerState.init(AnalyzerConfig(num_partitions=2), "cpu"))
    for device in (None, "gpu", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            state_from_numpy(leaves, device=device)
    state = state_from_numpy(leaves, device="cpu")
    assert state.metrics.per_partition.device == torch.device("cpu")
