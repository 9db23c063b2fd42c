"""DeepSeek-67B — llama-architecture dense decoder.

[arXiv:2401.02954]  95 layers, d_model 8192, 64 heads (GQA kv=8,
head_dim 128), d_ff 22016, vocab 102400.
"""
from repro_torch.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    arch_type="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    vocab_size=102_400,
    layer_pattern=("attn",),
    ffn_kind="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    lora=LoRAConfig(rank=8, alpha=16.0, targets=("q", "v")),
    source="arXiv:2401.02954 (DeepSeek LLM 67B)",
)
