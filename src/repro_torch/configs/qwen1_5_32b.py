"""Qwen1.5-32B — dense decoder with QKV bias.

[hf:Qwen/Qwen1.5 family]  64 layers, d_model 5120, 40 heads (GQA kv=40 —
i.e. MHA at this scale per the assignment), d_ff 27392, vocab 152064.
"""
from repro_torch.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27_392,
    vocab_size=152_064,
    layer_pattern=("attn",),
    qkv_bias=True,
    ffn_kind="swiglu",
    rope_theta=1_000_000.0,
    lora=LoRAConfig(rank=8, alpha=16.0, targets=("q", "v")),
    source="hf:Qwen/Qwen1.5-0.5B (scaled per assignment)",
)
