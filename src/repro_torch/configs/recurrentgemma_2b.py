"""RecurrentGemma-2B — Griffin hybrid: RG-LRU + local attention, 1:2 ratio.

[arXiv:2402.19427]  26 layers, d_model 2560, 10 heads (MQA kv=1, head_dim
256), d_ff 7680 (GeGLU), vocab 256000, lru_width 2560, local attention
window 2048, embeddings scaled by sqrt(d_model); pattern (rglru, rglru,
local_attn), so 26 = 8 * 3 + 2 leaves two recurrent tail layers.
"""
from repro_torch.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    layer_pattern=("rglru", "rglru", "local_attn"),
    window_size=2048,
    lru_width=2560,
    ffn_kind="geglu",
    embed_scale=True,
    rope_theta=10_000.0,
    lora=LoRAConfig(rank=8, alpha=16.0, targets=("q", "v")),
    source="arXiv:2402.19427 (RecurrentGemma / Griffin)",
)
