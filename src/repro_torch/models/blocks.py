"""Transformer block: pre-norm attention and FFN with residuals (port of
``repro/models/blocks.py``).  This slice runs the ``"attn"`` mixer with an
FFN; the other mixers, MoE and cross-attention raise."""
from __future__ import annotations

from torch import nn

from repro_torch.models import attention, ffn, layers

PORTED_MIXERS = ("attn",)


def check_ported(cfg) -> None:
    """Raise for any part of ``cfg`` this slice does not run."""
    missing = []
    if any(k not in PORTED_MIXERS for k in cfg.layer_pattern):
        missing.append(f"mixers {cfg.layer_pattern}")
    if cfg.n_experts:
        missing.append("MoE")
    if cfg.encoder_decoder:
        missing.append("cross-attention")
    if cfg.frontend:
        missing.append(f"the {cfg.frontend} frontend")
    if cfg.mrope:
        missing.append("M-RoPE")
    if cfg.kv_quant:
        missing.append("the int8 KV cache")
    if not cfg.tie_embeddings:
        missing.append("an untied output head")
    if cfg.embed_scale or cfg.d_ff == 0 or cfg.ffn_kind != "swiglu":
        missing.append(f"embed_scale={cfg.embed_scale}, d_ff={cfg.d_ff}, ffn {cfg.ffn_kind!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP.md queue 1, item 8)"
        )


class Block(nn.Module):
    """One layer: ``norm1``, ``mixer`` (q, k, v, o), ``norm2``, ``ffn``
    (gate, up, down), keyed as the reference's block pytree."""

    def __init__(self, cfg, gen, *, dtype, device):
        super().__init__()
        self.norm1 = layers.init_norm(cfg.norm_kind, cfg.d_model, device)
        self.mixer = attention.init_attention(gen, cfg, dtype=dtype, device=device)
        self.norm2 = layers.init_norm(cfg.norm_kind, cfg.d_model, device)
        self.ffn = ffn.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind, dtype=dtype,
                                device=device)

    def forward(self, x, lora, cfg, *, positions, mode: str, cache=None, cache_index=None):
        """Returns (x, new_cache); ``new_cache`` is ``{"self": KVCache}`` in
        prefill and decode, None otherwise."""
        lora = lora or {}
        h = layers.apply_norm(self.norm1, x, cfg.norm_eps)
        out, new_self = attention.apply_attention(
            self.mixer, lora.get("mixer"), h, cfg, positions=positions,
            cache=None if cache is None else cache["self"], cache_index=cache_index,
            return_cache=mode == "prefill",
        )
        x = x + out
        h2 = layers.apply_norm(self.norm2, x, cfg.norm_eps)
        x = x + ffn.apply_ffn(self.ffn, h2, cfg.ffn_kind)
        return x, ({"self": new_self} if mode in ("prefill", "decode") else None)
