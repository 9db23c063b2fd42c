"""StableLM-2-1.6B — dense decoder, LayerNorm, partial rotary (25%).

[hf:stabilityai/stablelm-2-1_6b]  24 layers, d_model 2048, 32 heads
(MHA kv=32, head_dim 64), d_ff 5632, vocab 100352.
"""
from repro_torch.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100_352,
    layer_pattern=("attn",),
    norm_kind="layernorm",
    rope_pct=0.25,
    ffn_kind="swiglu",
    rope_theta=10_000.0,
    lora=LoRAConfig(rank=8, alpha=16.0, targets=("q", "v")),
    source="hf:stabilityai/stablelm-2-1_6b",
)
