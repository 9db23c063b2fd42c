"""Gemma-7B — dense decoder: GeGLU, head_dim 256, embedding scaling.

[arXiv:2403.08295]  28 layers, d_model 3072, 16 heads (MHA kv=16,
head_dim 256), d_ff 24576 (GeGLU), vocab 256000, tied embeddings scaled by
sqrt(d_model).  (The 2B sibling uses MQA; 7B is MHA.)
"""
from repro_torch.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    arch_type="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    vocab_size=256_000,
    layer_pattern=("attn",),
    ffn_kind="geglu",
    embed_scale=True,
    rope_theta=10_000.0,
    lora=LoRAConfig(rank=8, alpha=16.0, targets=("q", "v")),
    source="arXiv:2403.08295 (Gemma 7B)",
)
