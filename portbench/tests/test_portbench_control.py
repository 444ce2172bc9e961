"""The controls of the limits, on the card at each cell's own size: the
reference put in the program's place in the configuration's lower
precision (TF32 for fp32, fp8 for bf16) comes out not correct. The train
cells' limits are also held against the loss taken over half of each
batch. Each decides inside the test whether there is a card."""

from __future__ import annotations

import contextlib
import io
import json
import time

import pytest

from portbench.harness import ROOT, run

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CONTROLS = [(c, "precision") for c in CELLS] + [(c, "half_batch") for c in CELLS if "train" in c]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control", CONTROLS)
def test_the_control_is_not_correct(cell, control):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's own size")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run(["--workload", cell, "--seed", "2147483711", "--seconds", "1",
                  "--control", control], time.perf_counter())
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is False, line["checks"]
