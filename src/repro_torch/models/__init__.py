"""Models of the port: the LM that ``launch/serve.py`` serves and
``launch/train.py`` fine-tunes, with attention (``"attn"``), Mamba-2 SSD
(``"ssd"``), or RG-LRU (``"rglru"``) and sliding-window attention
(``"local_attn"``) blocks, each with a gated or GELU FFN or a mixture of
experts (``moe``); with an encoder and cross-attention for an
encoder-decoder config (Whisper), M-RoPE and a vision stub for a VLM
(Qwen2-VL), and an int8 KV cache with ``kv_quant``."""
from repro_torch.models.model import (
    DecoderLM,
    client_losses,
    decode_step,
    encode,
    extend_caches,
    forward,
    init_decode_caches,
    init_lora_params,
    init_params,
    loss_fn,
)
from repro_torch.models import attention, blocks, ffn, kvcache, layers, moe, rglru, ssd

__all__ = [
    "DecoderLM", "client_losses", "decode_step", "encode", "extend_caches", "forward",
    "init_decode_caches", "init_lora_params", "init_params", "loss_fn", "attention", "blocks",
    "ffn", "kvcache", "layers", "moe", "rglru", "ssd",
]
