"""On the card: each cell at its own size, a short window, comes out
correct, and its control (the reference kept to 64 recipients in the
program's place) does not. Skips on a host without a card; run with
``python3 -m pytest wqlbench/tests/test_wqlbench_card.py -m cuda``."""

import json
import subprocess
import sys

import pytest

from .conftest import ROOT

CELLS = ["crowd1m.local"]


def _run(workload, seed, *extra):
    res = subprocess.run(
        [sys.executable, "-m", "wqlbench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", "5", "--trace", "0", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_correct_and_control_not(card, workload):
    sound = _run(workload, 2**31 + 101)
    assert sound["correct"] is True
    assert sound["device"]["kind"] == card
    # setup_s and the card's time at least, each above 0
    assert len(sound["metrics"]) >= 2
    assert all(m["value"] > 0 for m in sound["metrics"].values())
    control = _run(workload, 2**31 + 102, "--control", "cap64")
    assert control["correct"] is False
    print(workload, "control wrong_answers",
          control["checks"]["wrong_answers"]["value"])
