"""On the card: one short run of each one-chip cell through ``run.py``
comes out correct. Run with ``python -m pytest -m cuda port_bench/tests``
on a machine with a GPU; elsewhere it skips."""

import json
import os
import subprocess
import sys

import pytest

from port_bench import registry

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture
def gpus():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this machine")
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  registry.benchmark()["workloads"]])
def test_cell_runs_correct(gpus, cell):
    chips = registry.cell(registry.benchmark(), cell)["chips"]
    if gpus < chips:
        pytest.skip(f"{cell} needs {chips} GPUs")
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
