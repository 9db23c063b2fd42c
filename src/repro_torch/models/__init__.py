"""Models of the port: the decoder LM that ``launch/serve.py`` serves and
``launch/train.py`` fine-tunes, with attention (``"attn"``), Mamba-2 SSD
(``"ssd"``), or RG-LRU (``"rglru"``) and sliding-window attention
(``"local_attn"``) blocks, each with a gated FFN or a mixture of experts
(``moe``)."""
from repro_torch.models.model import (
    DecoderLM,
    client_losses,
    decode_step,
    extend_caches,
    forward,
    init_decode_caches,
    init_lora_params,
    init_params,
    loss_fn,
)
from repro_torch.models import attention, blocks, ffn, kvcache, layers, moe, rglru, ssd

__all__ = [
    "DecoderLM", "client_losses", "decode_step", "extend_caches", "forward", "init_decode_caches",
    "init_lora_params", "init_params", "loss_fn", "attention", "blocks", "ffn", "kvcache",
    "layers", "moe", "rglru", "ssd",
]
