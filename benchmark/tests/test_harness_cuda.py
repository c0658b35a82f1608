"""A cell at its own size on the card: skips without one."""

from __future__ import annotations

import json

import pytest

from benchmark import run


@pytest.mark.cuda
def test_demo_audit_on_the_card(capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc = run.main(["--workload", "demo-compacted.audit", "--seed", "424242",
                   "--seconds", "3", "--trace", "0"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    result = json.loads(out[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
