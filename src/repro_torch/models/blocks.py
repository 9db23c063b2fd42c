"""Decoder block: pre-norm mixer and optional FFN or MoE with residuals
(port of ``repro/models/blocks.py``).  This slice runs the ``"attn"`` mixer
(full causal attention), ``"local_attn"`` (sliding-window attention, a ring
cache at decode), ``"ssd"`` (Mamba-2) and ``"rglru"`` (Griffin's RG-LRU),
each with a SwiGLU or GeGLU FFN when ``d_ff > 0`` (a mixture of SwiGLU
experts when ``n_experts > 0``) and none when ``d_ff == 0``;
cross-attention and the plain GELU FFN raise."""
from __future__ import annotations

from torch import nn

from repro_torch.models import attention, ffn, layers, moe, rglru, ssd

ATTN_KINDS = ("attn", "local_attn")
PORTED_MIXERS = ATTN_KINDS + ("ssd", "rglru")


def check_ported(cfg) -> None:
    """Raise for any part of ``cfg`` this slice does not run."""
    missing = []
    if any(k not in PORTED_MIXERS for k in cfg.layer_pattern):
        missing.append(f"mixers {cfg.layer_pattern}")
    if cfg.encoder_decoder:
        missing.append("cross-attention")
    if cfg.frontend:
        missing.append(f"the {cfg.frontend} frontend")
    if cfg.mrope:
        missing.append("M-RoPE")
    if cfg.kv_quant:
        missing.append("the int8 KV cache")
    if cfg.d_ff and not cfg.n_experts and cfg.ffn_kind not in ffn.GATED:
        missing.append(f"ffn {cfg.ffn_kind!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP.md queue 1, item 8)"
        )


def lora_dims(cfg, kind: str) -> dict:
    """{target: (d_in, d_out)} of the adapters of a ``kind`` block: the
    attention projections in ``cfg.lora.targets``, or the recurrent mixers'
    input ("q": SSD ``in_proj``, RG-LRU ``proj_x``) and output ("v":
    ``out_proj``) projections."""
    if kind == "ssd":
        return ssd.lora_dims(cfg)
    if kind == "rglru":
        return rglru.lora_dims(cfg)
    dims = attention.lora_dims(cfg)
    return {t: dims[t] for t in cfg.lora.targets}


class Block(nn.Module):
    """One layer: ``norm1``, ``mixer`` (attention q, k, v, o, the SSD mixer
    or the RG-LRU block) and, when ``d_ff > 0``, ``norm2`` and ``ffn``
    (gate, up, down) or, when ``n_experts > 0``, ``moe`` (router and the
    stacked experts), keyed as the reference's block pytree."""

    def __init__(self, cfg, kind: str, gen, *, dtype, device):
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
        if cfg.d_ff > 0:
            self.norm2 = layers.init_norm(cfg.norm_kind, cfg.d_model, device)
            if cfg.n_experts > 0:
                self.moe = moe.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, dtype=dtype,
                                        device=device)
            else:
                self.ffn = ffn.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind, dtype=dtype,
                                        device=device)

    def forward(self, x, lora, cfg, *, positions, mode: str, cache=None, cache_index=None,
                groups: int = 1):
        """Returns (x, new_cache, aux); ``new_cache`` is ``{"self": KVCache}``,
        ``{"self": SSMState}`` or ``{"self": LRUState}`` in prefill and
        decode, None otherwise; ``aux`` (groups,) is the MoE's load-balance
        loss of each of ``groups`` contiguous row groups (``moe.apply_moe``),
        None without experts."""
        lora = lora or {}
        h = layers.apply_norm(self.norm1, x, cfg.norm_eps)
        self_cache = None if cache is None else cache["self"]
        prefill = mode == "prefill"
        if self.kind in ATTN_KINDS:
            out, new_self = attention.apply_attention(
                self.mixer, lora.get("mixer"), h, cfg, positions=positions,
                window=cfg.window_size if self.kind == "local_attn" else 0, cache=self_cache,
                cache_index=cache_index, return_cache=prefill,
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
        aux = None
        if cfg.d_ff > 0:
            h2 = layers.apply_norm(self.norm2, x, cfg.norm_eps)
            if cfg.n_experts > 0:
                out, aux = moe.apply_moe(self.moe, h2, top_k=cfg.top_k,
                                         capacity_factor=cfg.capacity_factor, groups=groups)
                x = x + out
            else:
                x = x + ffn.apply_ffn(self.ffn, h2, cfg.ffn_kind)
        return x, ({"self": new_self} if mode in ("prefill", "decode") else None), aux
