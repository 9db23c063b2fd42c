"""The comparison that decides ``correct`` fails where it must: the
control (the reference put in the program's place at the precision below
the configuration's) and each fault a cell can have, planted under the
timed path, at a size the CPU runs in seconds, held to the cells' own
limits.  The card's readings at the cells' sizes are in PERF.md."""
from __future__ import annotations

import time

import pytest

from bench.conftest import tiny_cell
from bench.harness import checks, manifest

SEED = 2**31 + 12345
FED = ["stablelm-2-1.6b.fedround", "granite-3.0-1b-a400m.fedround"]


@pytest.mark.parametrize("workload", FED)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_fedround_fault_is_not_correct(workload, fault):
    cell = tiny_cell(workload)
    out = manifest.driver("fedround").run(cell, SEED, 0.0, False, "cpu", time.perf_counter(),
                                          fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", FED)
def test_fedround_control_is_not_correct(workload):
    drv = manifest.driver("fedround")
    cell = tiny_cell(workload)
    want = drv.follow(cell, SEED, "cpu", cell["mix"]["checked_rounds"])
    got = drv.follow(cell, SEED, "cpu", cell["mix"]["checked_rounds"], quant="fp8")
    ok, report = checks.judge(drv.compare(got, want), cell["checks"]["limits"])
    assert not ok, report


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_agg_fault_is_not_correct(fault):
    cell = tiny_cell("stablelm-2-1.6b.agg40")
    out = manifest.driver("agg").run(cell, SEED, 0.0, False, "cpu", time.perf_counter(),
                                     fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.gpu
def test_agg_control_is_not_correct(cuda_card):
    """TF32 products exist on a card only; the card holds the cell's own
    size (the reference's three calls take seconds there)."""
    from bench.reference import rpca

    drv = manifest.driver("agg")
    cell = manifest.cell("stablelm-2-1.6b.agg40")
    want = drv.follow(cell, SEED, "cuda", cell["mix"]["checked_calls"])
    import torch

    with rpca.tf32(True):
        got = drv.follow(cell, SEED, "cuda", cell["mix"]["checked_calls"], dtype=torch.float32)
    ok, report = checks.judge({"update_gap": drv.compare(got, want)}, cell["checks"]["limits"])
    assert not ok, report


@pytest.mark.gpu
def test_run_on_the_card(cuda_card):
    """One short run of the aggregation cell through the command."""
    import json
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, str(manifest.BENCH / "run.py"), "--workload", "stablelm-2-1.6b.agg40",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
