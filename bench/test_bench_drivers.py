"""Both drivers at a tiny size on the CPU against the plain reference:
with the program in float32 the two must agree to rounding."""
from __future__ import annotations

import time

import pytest

from bench.conftest import tiny_cell
from bench.harness import manifest

SEED = 2**31 + 12345  # past 32 signed bits, as the driver's are


@pytest.mark.parametrize("workload", ["stablelm-2-1.6b.fedround",
                                      "granite-3.0-1b-a400m.fedround"])
def test_fedround_matches_reference_in_float32(workload):
    cell = tiny_cell(workload, dtype="float32")
    out = manifest.driver("fedround").run(cell, SEED, 0.0, False, "cpu", time.perf_counter())
    r = out["readings"]
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-4
    assert r["delta_gap"] < 1e-3 and r["update_gap"] < 1e-2
    assert out["attempted"] == 1 and out["failed"] == 0 and out["e2e"]["round_s"] > 0


def test_agg_matches_reference():
    cell = tiny_cell("stablelm-2-1.6b.agg40")
    out = manifest.driver("agg").run(cell, SEED, 0.0, False, "cpu", time.perf_counter())
    assert out["readings"]["update_gap"] < 1e-4
    assert out["correct"] and out["attempted"] == 1 and out["failed"] == 0
    assert out["record"]["window"]["fallbacks"][0] >= 1
