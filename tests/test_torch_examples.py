"""The port's examples (``repro_torch.examples``), twins of ``examples/``, on
the CPU (``--device cpu``) at the reduced arguments of
``tests/test_examples.py``: each prints the reference example's lines, and
``serve_lora`` keeps its assertions (the gap to the merged baseline, only
tenant 0's continuations moving after the hot swap).

``serve_lora`` runs at its defaults (4 requests, prompt 12, 8 tokens, 3
tenants), which cost a fraction of a second on the CPU: at the reference
test's (2, 6, 3, 2) the port's random weights (torch's draws, other numbers
than JAX's) greedily repeat tenant 0's input token before and after the
swap, so there is no continuation for the swap to move.
``fed_finetune_lm`` runs its 12-layer target at 2 layers and a 512-token
vocabulary (``CFG_100M`` replaced), 2 rounds of 2 clients.  The LM
corpus's lazily formed rows give the reference's bits (checked here).
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import synthetic as jsynthetic
from repro_torch.data import synthetic
from repro_torch.examples import compare_aggregators, fed_finetune_lm, quickstart, serve_lora

ROOT = Path(__file__).resolve().parents[1]


def test_quickstart_prints_both_methods(capsys):
    quickstart.main(rounds=2, n_clients=4, rpca_iters=5, local_steps=2, device="cpu")
    out = capsys.readouterr().out
    assert "zero-shot accuracy:" in out
    assert "fedavg" in out and "fedrpca" in out
    assert out.count("final=") == 2


def test_compare_aggregators_ranks_methods(capsys):
    compare_aggregators.main(["--rounds", "2", "--clients", "6", "--rpca-iters", "5",
                              "--local-steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    for name in compare_aggregators.METHODS:
        assert name in out
    assert "best:" in out


def test_compare_aggregators_methods_match_reference():
    spec = importlib.util.spec_from_file_location(
        "examples_compare_aggregators", ROOT / "examples" / "compare_aggregators.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert compare_aggregators.METHODS == ref.METHODS


def test_serve_lora_pool_serving_and_hotswap(capsys):
    gen_tokens, gen_after = serve_lora.main(device="cpu")
    out = capsys.readouterr().out
    assert "merged-baseline check" in out
    assert "hot-swap" in out
    assert gen_tokens.shape == gen_after.shape == (serve_lora.BATCH, serve_lora.GEN)


def test_fed_finetune_lm_runs_the_fed_train_step(capsys, monkeypatch, tmp_path):
    small = fed_finetune_lm.CFG_100M.replace(n_layers=2, vocab_size=512)
    monkeypatch.setattr(fed_finetune_lm, "CFG_100M", small)
    fed_finetune_lm.main(["--rounds", "2", "--clients", "2", "--seq", "16",
                          "--per-client-batch", "1", "--ckpt-dir", str(tmp_path),
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "base params:" in out and "initial eval loss:" in out
    assert out.count("round 00") == 2
    assert "done: 2 rounds x 2 local steps = 4 LoRA steps per client" in out


@pytest.mark.parametrize("vocab,h", [(64, 0.5), (300, 0.6), (1024, 0.3)])
def test_lm_corpus_rows_formed_lazily_keep_the_reference_bits(vocab, h):
    got = synthetic.client_lm_datasets(3, vocab_size=vocab, n_seqs=8, seq_len=16,
                                       heterogeneity=h, seed=2)
    want = jsynthetic.client_lm_datasets(3, vocab_size=vocab, n_seqs=8, seq_len=16,
                                         heterogeneity=h, seed=2)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1].tokens, want[1].tokens)


def test_examples_refuse_the_card_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main(rounds=1, n_clients=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_lora.main()


def test_examples_run_as_modules():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_lora", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "requests with changed continuations: [0, 3]" in out.stdout
