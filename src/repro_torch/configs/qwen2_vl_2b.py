"""Qwen2-VL-2B — VLM language backbone with M-RoPE, dynamic resolution.

[arXiv:2409.12191]  28 layers, d_model 1536, 12 heads (GQA kv=2,
head_dim 128), d_ff 8960, vocab 151936, QKV bias, M-RoPE sections
(16, 24, 24) frequency pairs for (temporal, height, width).

Vision frontend (ViT + merger) is a stub: the model takes precomputed patch
embeddings ``batch["vision_embeds"]`` (B, n_vision_tokens, d_model), which
``launch/serve.py::_make_batch`` draws from the CLI's seed, and optional 3-D
M-RoPE position ids ``batch["positions"]`` (3, B, S).
"""
from repro_torch.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    layer_pattern=("attn",),
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    frontend="vision",
    n_vision_tokens=256,
    ffn_kind="swiglu",
    rope_theta=1_000_000.0,
    lora=LoRAConfig(rank=8, alpha=16.0, targets=("q", "v")),
    source="arXiv:2409.12191 (Qwen2-VL)",
)
