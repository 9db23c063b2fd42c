"""Models of the port: the decoder LM that ``launch/serve.py`` serves."""
from repro_torch.models.model import (
    DecoderLM,
    decode_step,
    extend_caches,
    forward,
    init_decode_caches,
    init_lora_params,
    init_params,
    loss_fn,
)
from repro_torch.models import attention, blocks, ffn, kvcache, layers

__all__ = [
    "DecoderLM", "decode_step", "extend_caches", "forward", "init_decode_caches",
    "init_lora_params", "init_params", "loss_fn", "attention", "blocks", "ffn", "kvcache",
    "layers",
]
