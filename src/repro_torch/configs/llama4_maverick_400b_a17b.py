"""Llama-4 Maverick 400B-A17B — MoE with 128 experts, top-1 routing.

[hf:meta-llama/Llama-4-Scout-17B-16E family]  48 layers, d_model 5120,
40 heads (GQA kv=8, head_dim 128), expert d_ff 8192, vocab 202048,
128 experts top-1 (early-fusion multimodal in the original; the language
backbone is what's assigned).
"""
from repro_torch.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    layer_pattern=("attn",),
    n_experts=128,
    top_k=1,
    capacity_factor=1.25,
    ffn_kind="swiglu",
    rope_theta=500_000.0,
    lora=LoRAConfig(rank=8, alpha=16.0, targets=("q", "v")),
    source="hf:meta-llama/Llama-4-Scout-17B-16E (Maverick config per assignment)",
)
