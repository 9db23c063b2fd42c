"""Whisper-medium — encoder-decoder audio model (conv/mel frontend STUB).

[arXiv:2212.04356]  24 encoder + 24 decoder layers, d_model 1024, 16 heads
(MHA kv=16, head_dim 64), d_ff 4096, vocab 51865, LayerNorm, GELU MLP,
learned absolute positions (no RoPE), 1500 encoder frames (30 s audio).

The mel-spectrogram + conv feature extractor is a stub: the model takes
precomputed frame embeddings ``batch["encoder_frames"]`` (B, 1500, d_model),
which ``launch/serve.py::_make_batch`` draws from the CLI's seed.
"""
from repro_torch.config import LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    layer_pattern=("attn",),
    encoder_decoder=True,
    n_encoder_layers=24,
    encoder_seq=1500,
    frontend="audio",
    norm_kind="layernorm",
    ffn_kind="gelu",
    qkv_bias=True,
    lora=LoRAConfig(rank=8, alpha=16.0, targets=("q", "v")),
    source="arXiv:2212.04356 (Whisper medium)",
)
