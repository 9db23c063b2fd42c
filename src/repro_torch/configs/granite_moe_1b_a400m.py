"""Granite-3.0-1B-A400M — MoE with 32 experts, top-8 routing.

[hf:ibm-granite/granite-3.0-1b-a400m-base]  24 layers, d_model 1024,
16 heads (GQA kv=8, head_dim 64), expert d_ff 512, vocab 49155,
32 experts top-8.
"""
from repro_torch.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    layer_pattern=("attn",),
    n_experts=32,
    top_k=8,
    capacity_factor=1.25,
    ffn_kind="swiglu",
    rope_theta=10_000.0,
    lora=LoRAConfig(rank=8, alpha=16.0, targets=("q", "v")),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
