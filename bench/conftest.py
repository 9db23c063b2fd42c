"""Test settings of the benchmark's own tests."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

_SRC = str(Path(__file__).resolve().parents[1] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    """Skip a test that needs a CUDA card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def tiny_cell(workload: str, **spec_over) -> dict:
    """A cell of the manifest at a size the CPU runs in a second: two
    layers of width 64, three clients of two 16-token sequences (ten for
    the aggregation), 20 ADMM iterations."""
    from bench.harness import manifest

    cell = manifest.cell(workload)
    spec = dict(cell["config"], n_layers=2, d_model=64, n_heads=4, head_dim=16,
                vocab_size=160)
    if spec["n_experts"]:
        spec.update(n_kv_heads=2, d_ff=32, n_experts=4, top_k=2)
    else:
        spec.update(n_kv_heads=4, d_ff=96)
    spec.update(spec_over)
    mix = dict(cell["mix"], aggregator=dict(cell["mix"]["aggregator"], rpca_iters=20))
    if mix["driver"] == "fedround":
        mix.update(clients=3, seq=16, n_seqs=8, vocab_cap=128)
    else:
        mix.update(clients=10)
    return dict(cell, config=spec, mix=mix)
