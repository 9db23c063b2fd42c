"""The yardstick's operation and byte counts against hand counts."""
from __future__ import annotations

import json

from bench.harness import manifest, readers
from bench.work import counts


def test_lora_call():
    # 4 rows, K 3, N 2, rank 1, two slots: 2*4*3*2 + 2*4*3*1 + 2*4*1*2 = 48 + 24 + 16.
    flops, nbytes = counts.lora_call(4, 3, 2, 1, 2)
    assert flops == 88
    # bf16 x (12), W (6), y (8) = 26 * 2; fp32 pools 2 * (3 + 2) * 4 = 40; slots 16.
    assert nbytes == 52 + 40 + 16


def test_kept_pairs_and_attention():
    assert counts.kept_pairs(4) == 10 and counts.kept_pairs(4, causal=False) == 16
    assert counts.kept_pairs(5, window=2) == 3 + 3 * 2  # rows 1, 2, 2, 2, 2
    flops, nbytes = counts.attention_call(bh=2, bh_kv=1, s=4, d=8)
    assert flops == 4 * 2 * 10 * 8
    assert nbytes == 2 * 4 * 8 * (2 * 2 + 2 * 1)


def test_subspace_apply_call():
    flops, nbytes = counts.subspace_apply_call(b=2, vec=5, d2=3)
    assert flops == 4 * 2 * 5 * 9
    assert nbytes == 4 * (6 * 30 + 2 * 18 + 8)


def test_bound_picks_the_larger():
    assert counts.bound_s(1e12, 1e9, 1e12, 1e12) == 1.0
    assert counts.bound_s(1e9, 2e12, 1e12, 1e12) == 2.0


def test_local_phase_flops_by_hand():
    spec = {"d_model": 4, "d_ff": 6, "vocab_size": 10, "head_dim": 2, "n_heads": 2,
            "n_kv_heads": 1, "n_layers": 3, "n_experts": 0, "top_k": 0,
            "lora": {"rank": 1, "targets": ["q", "v"]}}
    # a token of a layer: q 2*4*4, k 2*4*2, v 2*4*2, o 2*4*4 = 96; SwiGLU 3*2*4*6 = 144.
    # LoRA q 2*4*1 + 2*1*4 = 16, v 2*4*1 + 2*1*2 = 12.  Head 2*4*10 = 80.
    # Attention of one sequence of 3: 4 * 2 heads * 2 dims * 6 pairs = 96.
    tokens, seqs = 2 * 1 * 3, 2
    fwd = 3 * (tokens * (240 + 28) + 96 * seqs) + tokens * 80
    bwd = 3 * (tokens * (240 + 56) + 2 * 96 * seqs) + tokens * 80
    assert counts.local_phase_flops(spec, 2, 1, 3, 2) == 2 * (fwd + bwd)
    moe = dict(spec, n_experts=4, top_k=2)
    per = 96 + 2 * 4 * 4 + 2 * 3 * 2 * 4 * 6
    fwd = 3 * (tokens * (per + 28) + 96 * seqs) + tokens * 80
    bwd = 3 * (tokens * (per + 56) + 2 * 96 * seqs) + tokens * 80
    assert counts.local_phase_flops(moe, 2, 1, 3, 1) == fwd + bwd


def test_round_flops_of_the_stablelm_cell():
    spec = json.loads((manifest.BENCH / "configs" / "stablelm-2-1.6b.json").read_text())
    f = counts.local_phase_flops(spec, 8, 2, 1024, 2)
    assert 1.9e14 < f < 2.1e14  # about 6 GFLOP a token a step


def test_roofline_reader_is_none_without_a_trace():
    assert readers.roofline({"calls": {}}, "bench.lora") is None
    rec = {"trace": {"spans": {"bench.lora": {"device_s": 1e-3}}},
           "peaks": (3.35e12, {"bf16": 989e12, "tf32": 495e12}),
           "calls": {"bench.lora": [(4096, 2048, 2048, 8, 8)]}}
    share = readers.roofline(rec, "bench.lora")
    flops, _ = counts.lora_call(4096, 2048, 2048, 8, 8)
    assert abs(share - 100.0 * flops / 989e12 / 1e-3) < 1e-9
