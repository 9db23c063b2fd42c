"""The fit of the planted aggregation traffic to the program's own client
deltas: its statistics recover planted parameters, and the whole
measurement runs at a tiny size on the CPU."""
from __future__ import annotations

import pytest

from bench import fit_traffic as F
from bench.conftest import tiny_cell

SEED = 2**31 + 12345


def test_refine_recovers_planted_parameters():
    p = {"rank": 4, "drift": 0.2, "density": 0.01, "sparse_scale": 3.0, "noise": 0.5,
         "client_spread": 1.0, "scale": 1e-3}
    blocks = {("q", "A"): (4, 4096), ("q", "B"): (4, 4096)}
    names = [("q", f, i) for f in ("A", "B") for i in range(4)]
    rank_of = {"A": 4, "B": 4}
    warm = F.summary([F.round_stats(m, names, rank_of)
                      for m in F.planted_rounds(blocks, 40, p, SEED, "cpu", 4)[1:]])
    fitted = F.fit(warm, rank_of)
    for _ in range(3):
        got = F.summary([F.round_stats(m, names, rank_of) for m in
                         F.planted_rounds(blocks, 40, {"by_factor": fitted}, SEED + 1, "cpu",
                                          4)[1:]])
        fitted = F.refine(fitted, warm, got)
    for f in ("A", "B"):
        q = fitted[f]
        assert q["scale"] == pytest.approx(1e-3, rel=0.05)
        assert q["noise"] == pytest.approx(0.5, rel=0.1)
        assert q["client_spread"] == pytest.approx(1.0, rel=0.2)
        assert q["density"] == pytest.approx(0.01, rel=0.5)


def test_measure_runs_at_a_tiny_size():
    fed = tiny_cell("stablelm-2-1.6b.fedround")
    agg = tiny_cell("stablelm-2-1.6b.agg40")
    mix = dict(agg["mix"], clients=6)
    rec = F.measure(fed["config"], fed["mix"], mix, 3, SEED, "cpu")
    assert len(rec["real"]["fallbacks"]) == 3
    assert set(rec["fitted"]) == {"A", "B"} and all(q["scale"] > 0
                                                  for q in rec["fitted"].values())
    assert set(rec["planted"]) == {"fitted", "mix"}
    assert all(len(v["fallbacks"]) == 3 for v in rec["planted"].values())
