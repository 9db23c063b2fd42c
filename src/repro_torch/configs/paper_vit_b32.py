"""Paper-analogue config: CLIP ViT-B/32-sized transformer with LoRA r=4.

The paper fine-tunes CLIP ViT-B/32 (12 layers, d_model 768, 12 heads,
d_ff 3072) with LoRA rank 4 on Q and V.  We model the transformer tower as a
causal LM of the same dimensions for the federated benchmarks (the
aggregation math is independent of the head task).
"""
from repro_torch.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="paper-vit-b32",
    arch_type="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=49_408,
    layer_pattern=("attn",),
    norm_kind="layernorm",
    ffn_kind="gelu",
    qkv_bias=True,
    lora=LoRAConfig(rank=4, alpha=8.0, targets=("q", "v")),
    source="arXiv:2103.00020 (CLIP ViT-B/32) — paper's backbone",
)
