"""Mamba2-130M — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060]  24 layers, d_model 768, d_inner 1536 (expand 2),
ssm_state 128, head_dim 64 (24 SSD heads), conv width 4, vocab 50280,
no FFN (the SSD mixer is the whole block).
"""
from repro_torch.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,  # unused by SSD blocks; kept for config completeness
    n_kv_heads=12,
    d_ff=0,
    vocab_size=50_280,
    layer_pattern=("ssd",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_width=4,
    lora=LoRAConfig(rank=8, alpha=16.0, targets=("q", "v")),  # in/out proj
    source="arXiv:2405.21060 (Mamba-2 SSD)",
)
