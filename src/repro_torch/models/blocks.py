"""Transformer block: pre-norm mixer, optional cross-attention and optional
FFN or MoE, with residuals (port of ``repro/models/blocks.py``).  The mixer
is ``"attn"`` (full attention, causal or, in an encoder, bidirectional),
``"local_attn"`` (sliding-window attention, a ring cache at decode),
``"ssd"`` (Mamba-2) or ``"rglru"`` (Griffin's RG-LRU); decoder blocks of an
encoder-decoder config (Whisper) add cross-attention over the encoder's
output (``norm_cross``, ``cross``); the FFN is SwiGLU, GeGLU or the plain
GELU MLP when ``d_ff > 0`` (a mixture of SwiGLU experts when
``n_experts > 0``) and none when ``d_ff == 0``."""
from __future__ import annotations

from torch import nn

from repro_torch.models import attention, ffn, layers, moe, rglru, ssd

ATTN_KINDS = ("attn", "local_attn")


def lora_dims(cfg, kind: str) -> dict:
    """{target: (d_in, d_out)} of the adapters of a ``kind`` block's mixer:
    the attention projections in ``cfg.lora.targets``, or the recurrent
    mixers' input ("q": SSD ``in_proj``, RG-LRU ``proj_x``) and output ("v":
    ``out_proj``) projections; ``kind="cross"`` gives those of the
    cross-attention sub-block (the attention projections in
    ``cfg.lora.targets``)."""
    if kind == "ssd":
        return ssd.lora_dims(cfg)
    if kind == "rglru":
        return rglru.lora_dims(cfg)
    dims = attention.lora_dims(cfg)
    return {t: dims[t] for t in cfg.lora.targets}


class Block(nn.Module):
    """One layer: ``norm1``, ``mixer`` (attention q, k, v, o, the SSD mixer
    or the RG-LRU block), with ``cross=True`` ``norm_cross`` and ``cross``
    (cross-attention q, k, v, o), and, when ``d_ff > 0``, ``norm2`` and
    ``ffn`` (gate, up, down; up and down with biases for the GELU MLP) or,
    when ``n_experts > 0``, ``moe`` (router and the stacked experts), keyed
    as the reference's block pytree."""

    def __init__(self, cfg, kind: str, gen, *, dtype, device, cross: bool = False):
        super().__init__()
        self.kind = kind
        self.norm1 = layers.init_norm(cfg.norm_kind, cfg.d_model, device)
        if kind in ATTN_KINDS:
            self.mixer = attention.init_attention(gen, cfg, dtype=dtype, device=device)
        elif kind == "ssd":
            self.mixer = ssd.init_ssd(gen, cfg, dtype=dtype, device=device)
        elif kind == "rglru":
            self.mixer = rglru.init_rglru(gen, cfg, dtype=dtype, device=device)
        else:
            raise ValueError(kind)
        if cross:
            self.norm_cross = layers.init_norm(cfg.norm_kind, cfg.d_model, device)
            self.cross = attention.init_attention(gen, cfg, dtype=dtype, device=device)
        if cfg.d_ff > 0:
            self.norm2 = layers.init_norm(cfg.norm_kind, cfg.d_model, device)
            if cfg.n_experts > 0:
                self.moe = moe.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, dtype=dtype,
                                        device=device)
            else:
                self.ffn = ffn.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind, dtype=dtype,
                                        device=device)

    def forward(self, x, lora, cfg, *, positions, mode: str, cache=None, cache_index=None,
                groups: int = 1, encoder_out=None, use_rope: bool = True, causal: bool = True):
        """Returns (x, new_cache, aux); ``new_cache`` is ``{"self": KVCache}``
        (a ``QuantKVCache`` with ``cfg.kv_quant``), ``{"self": SSMState}`` or
        ``{"self": LRUState}`` in prefill and decode, with ``"cross"``, the
        cross cache of the encoder's K and V, in a block with cross-attention;
        None otherwise.  ``aux`` (groups,) is the MoE's load-balance loss of
        each of ``groups`` contiguous row groups (``moe.apply_moe``), None
        without experts.  ``encoder_out`` is the encoder's output, which
        cross-attention reads outside decode; ``use_rope`` and ``causal``
        reach the attention mixer (an encoder passes False for both)."""
        lora = lora or {}
        h = layers.apply_norm(self.norm1, x, cfg.norm_eps)
        self_cache = None if cache is None else cache["self"]
        prefill = mode == "prefill"
        if self.kind in ATTN_KINDS:
            out, new_self = attention.apply_attention(
                self.mixer, lora.get("mixer"), h, cfg, positions=positions,
                window=cfg.window_size if self.kind == "local_attn" else 0, cache=self_cache,
                cache_index=cache_index, use_rope=use_rope, causal=causal,
                return_cache=prefill,
            )
        elif self.kind == "ssd":
            out, new_self = ssd.apply_ssd(
                self.mixer, lora.get("mixer"), h, cfg, state=self_cache,
                lora_scale=cfg.lora.scale, return_state=prefill,
            )
        else:
            out, new_self = rglru.apply_rglru(
                self.mixer, lora.get("mixer"), h, cfg, state=self_cache,
                lora_scale=cfg.lora.scale, return_state=prefill,
            )
        x = x + out
        new_cache = {"self": new_self}
        if hasattr(self, "cross"):
            hc = layers.apply_norm(self.norm_cross, x, cfg.norm_eps)
            out, new_cache["cross"] = attention.apply_attention(
                self.cross, lora.get("cross"), hc, cfg, positions=positions,
                cache=None if cache is None else cache["cross"], encoder_out=encoder_out,
                use_rope=False, causal=False, return_cache=prefill, is_cross=True,
            )
            x = x + out
        aux = None
        if cfg.d_ff > 0:
            h2 = layers.apply_norm(self.norm2, x, cfg.norm_eps)
            if cfg.n_experts > 0:
                out, aux = moe.apply_moe(self.moe, h2, top_k=cfg.top_k,
                                         capacity_factor=cfg.capacity_factor, groups=groups)
                x = x + out
            else:
                x = x + ffn.apply_ffn(self.ffn, h2, cfg.ffn_kind)
        return x, (new_cache if mode in ("prefill", "decode") else None), aux
