"""On the card (marker ``cuda``; they skip without one): each cell runs from
the command line, short, and comes out correct; the control, the reference
in TF32 in the program's place at the cell's full size, comes out not
correct.  Run there with ``python3 -m pytest portbench/tests -m cuda``."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import calibrate
from portbench import cell as cells

WORKLOADS = [w["name"] for w in json.loads((cells.REPO / "BENCHMARK.json").read_text())[
    "workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_is_correct_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload,
                          "--seed", "4242424242", "--seconds", "3", "--trace", "0"],
                         cwd=cells.REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_on_the_card(card, workload):
    cell = cells.load_cell(workload)
    r = calibrate.reading(cell, 4242424243, 3, card, control=True)
    assert not cells.passed(cells.judge(cell, r["numbers"])), r
