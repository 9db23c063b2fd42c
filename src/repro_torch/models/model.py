"""Model assembly: the decoder LM, LoRA trees, prefill and decode (port of
``repro/models/model.py``).

The base model is an ``nn.Module``, ``DecoderLM``, with one ``Block`` per
layer (the reference scans a group axis instead).  LoRA trees, caches and
the adapter pool keep the reference's layout, so the pool, the aggregation
engine and the converter share it: layer ``i < n_groups * unit`` sits at
group ``i // unit`` of pattern slot ``i % unit``, e.g.
``{"groups": ({"mixer": {"q": {"A": (n_groups, d_in, r), "B": ...}, "v": ...}},), "tail": ()}``
and caches ``{"groups": ({"self": KVCache(k=(n_groups, B, S, n_kv, hd), v=...)},), "tail": ()}``
(``SSMState(h=(n_groups, B, H, P, N), conv=...)`` for an ``"ssd"`` slot,
``LRUState(h=(n_groups, B, W), conv=...)`` for ``"rglru"``).  Layers that
do not fill a whole unit (RecurrentGemma's 26 = 8 x 3 + 2) are the tail:
layer ``n_groups * unit + j`` is ``tree["tail"][j]``, with no group axis,
e.g. ``{"mixer": {"q": {"A": (d_in, r), ...}}}`` and ``{"self": LRUState(h=(B, W), ...)}``.

An encoder-decoder config (Whisper) adds ``DecoderLM.encoder`` (its own
stack of bidirectional attention blocks over the stub audio frames, with a
sinusoidal position table) and the decoder's learned position table
``pos_embed``; each decoder layer then carries a cross-attention
sub-block, its adapters under ``"cross"`` beside ``"mixer"`` and its cache
under ``"cross"`` beside ``"self"`` (the encoder's K and V, projected at
prefill and never padded).  A VLM config (Qwen2-VL) takes the stub
``vision_embeds`` over its first positions and rotates with M-RoPE.

Modes: ``train`` (full sequence, logits at every position, for
``loss_fn``), ``prefill`` (full prompt, caches, last-position logits) and
``decode`` (one token against the caches, written in place).  Training
differentiates the LoRA leaves only: the base weights are frozen
(``requires_grad=False``), and the kernels' backward passes are plain
PyTorch (``kernels/*.py``).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import backend
from repro_torch.models import blocks, layers, rglru, ssd
from repro_torch.models.kvcache import attn_cache

Tree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normal(shape, gen, *, dtype, device) -> nn.Parameter:
    """A frozen N(0, 0.02) weight, as the reference draws embeddings and
    heads; ``gen=None`` leaves it unfilled."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if gen is not None:
        t.normal_(0.0, 0.02, generator=gen)
    return layers._param(t)


def _sinusoidal(length: int, dim: int, device) -> torch.Tensor:
    """The encoder's fixed position table (length, dim) in float32: sines of
    position x 10000^(-i / (half - 1)), then cosines (the reference's
    ``model._sinusoidal``)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=device)
                     / max(half - 1, 1))
    ang = pos * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :dim]


#: Rows of the decoder's learned position table (encoder-decoder configs),
#: the reference's ``cfg_max_positions``.
MAX_POSITIONS = 32768


class Encoder(nn.Module):
    """Whisper's encoder: ``cfg.n_encoder_layers`` blocks of bidirectional
    full attention (no cross-attention, no adapters), ``final_norm`` and the
    sinusoidal ``pos_embed`` of ``cfg.encoder_seq`` rows in the model's
    dtype, keyed as the reference's ``params["encoder"]``."""

    def __init__(self, cfg, gen: Optional[torch.Generator], *, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(blocks.Block(cfg, "attn", gen, dtype=dtype, device=device)
                                    for _ in range(cfg.n_encoder_layers))
        self.final_norm = layers.init_norm(cfg.norm_kind, cfg.d_model, device)
        self.pos_embed = layers._param(
            _sinusoidal(cfg.encoder_seq, cfg.d_model, device).to(dtype))


class DecoderLM(nn.Module):
    """Token embedding, ``cfg.n_layers`` blocks (layer ``i`` of mixer
    ``cfg.layer_pattern[i % unit]``), final norm, and the output head: the
    embedding (tied) or, when ``not cfg.tie_embeddings``, ``lm_head``
    (d_model, vocab), N(0, 0.02) as the reference draws it.  An
    encoder-decoder config adds ``encoder`` (``Encoder``), the learned
    ``pos_embed`` (``MAX_POSITIONS``, d_model), N(0, 0.02), and a
    cross-attention sub-block in every layer.  ``gen=None`` allocates the
    weights unfilled, for the converter to write."""

    def __init__(self, cfg, gen: Optional[torch.Generator], *, device):
        super().__init__()
        dtype = _DTYPES[cfg.dtype]
        self.embed = _normal((cfg.vocab_size, cfg.d_model), gen, dtype=dtype, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = _normal((cfg.d_model, cfg.vocab_size), gen, dtype=dtype,
                                   device=device)
        self.final_norm = layers.init_norm(cfg.norm_kind, cfg.d_model, device)
        unit = len(cfg.layer_pattern)
        self.layers = nn.ModuleList(
            blocks.Block(cfg, cfg.layer_pattern[i % unit], gen, dtype=dtype, device=device,
                         cross=cfg.encoder_decoder)
            for i in range(cfg.n_layers)
        )
        if cfg.encoder_decoder:
            self.encoder = Encoder(cfg, gen, dtype=dtype, device=device)
            self.pos_embed = _normal((MAX_POSITIONS, cfg.d_model), gen, dtype=dtype,
                                     device=device)


def _device(device) -> torch.device:
    """``backend.resolve_device``, with ``"meta"`` passed through: tensors
    that have a shape and a dtype and no storage (the dry run counts and
    lays out the parameters of every config on them)."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else backend.resolve_device(dev)


def _generator(dev: torch.device, seed: int) -> Optional[torch.Generator]:
    """A generator on ``dev`` seeded with ``seed``; None on ``meta``, where
    nothing is drawn."""
    return None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)


def init_params(cfg, *, seed: int = 0, device="cuda") -> DecoderLM:
    """The base model with random weights drawn from ``seed`` by a
    ``torch.Generator`` on ``device`` (default the card; without CUDA this
    raises unless ``device="cpu"``; on ``"meta"`` it allocates and draws
    nothing).  The same seed gives other numbers on the CPU and on a card."""
    dev = _device(device)
    return DecoderLM(cfg, _generator(dev, seed), device=dev)


def init_lora_params(cfg, *, seed: int = 0, device="cuda") -> Tree:
    """One adapter in the reference's tree layout, A ~ N(0, 1/d_in), B = 0,
    in ``cfg.lora.dtype`` on ``device``; each pattern slot carries the
    adapters of its mixer and, in an encoder-decoder config, of its
    cross-attention (``blocks.lora_dims``).  The encoder has none.  On
    ``"meta"`` it allocates and draws nothing."""
    dev = _device(device)
    gen = _generator(dev, seed)
    dtype = _DTYPES[cfg.lora.dtype]

    def sub(dims, lead):
        return {t: layers.init_lora(gen, d_in, d_out, cfg.lora.rank, dtype=dtype, device=dev,
                                    lead=lead)
                for t, (d_in, d_out) in dims.items()}

    def one(kind, lead):
        node = {"mixer": sub(blocks.lora_dims(cfg, kind), lead)}
        if cfg.encoder_decoder:
            node["cross"] = sub(blocks.lora_dims(cfg, "cross"), lead)
        return node

    groups = tuple(one(kind, (cfg.n_pattern_groups,)) for kind in cfg.layer_pattern)
    return {"groups": groups, "tail": tuple(one(kind, ()) for kind in _tail_kinds(cfg))}


def _tail_kinds(cfg):
    """Mixer kinds of the tail layers."""
    unit = len(cfg.layer_pattern)
    return [cfg.layer_pattern[j % unit] for j in range(cfg.n_tail_layers)]


def _select(node, g: int):
    """Layer ``g``'s slice of a group-stacked tree; ``slots`` (one per
    request, shared by every layer) stays whole."""
    if isinstance(node, dict):
        return {k: (v if k == "slots" else _select(v, g)) for k, v in node.items()}
    return node[g]


def _layer_trees(tree, cfg):
    """Per-layer subtrees of a ``{"groups", "tail"}`` tree (None -> Nones):
    group layers sliced from their slot, then the tail's entries."""
    unit = len(cfg.layer_pattern)
    if tree is None:
        return [None] * cfg.n_layers
    n_grouped = cfg.n_pattern_groups * unit
    return ([_select(tree["groups"][i % unit], i // unit) for i in range(n_grouped)]
            + list(tree["tail"]))


def _layer_caches(caches, cfg):
    """Per-layer views ``{"self": KVCache | QuantKVCache | SSMState |
    LRUState[, "cross": KVCache]}`` of the group-stacked caches, then the
    tail's caches; writes through a view land in the stacked tensors."""
    unit = len(cfg.layer_pattern)
    if caches is None:
        return [None] * cfg.n_layers
    out = []
    for i in range(cfg.n_pattern_groups * unit):
        entry = caches["groups"][i % unit]
        out.append({key: type(state)(*(t[i // unit] for t in state))
                    for key, state in entry.items()})
    return out + [dict(c) for c in caches["tail"]]


def _stack_states(states):
    """One cache container of layer-stacked tensors from per-layer ones."""
    return type(states[0])(*(torch.stack(ts) for ts in zip(*states)))


def embed_tokens(model: DecoderLM, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Token embeddings (B, S, D) in the model's dtype, times sqrt(d_model)
    with ``embed_scale`` (Gemma): the factor is rounded to the activations'
    dtype first, as the reference rounds it (50.5 in bf16 at d_model 2560,
    not 50.596)."""
    x = F.embedding(tokens, model.embed)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def _embed_inputs(model: DecoderLM, batch: dict, cfg, mode: str, cache_index):
    """(x, positions) of a batch: the token embeddings (``embed_tokens``),
    with a VLM's ``batch["vision_embeds"]`` (B, n_vision, D) over the first
    positions outside decode (after ``embed_scale``, as the reference
    splices them) and the decoder's learned position at each position
    (``cache_index`` when decoding) where the model has ``pos_embed``.
    Positions are (B, S), or (3, B, S) for M-RoPE: ``batch["positions"]``
    when given, else all three streams equal."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_tokens(model, tokens, cfg)
    if cfg.frontend == "vision" and "vision_embeds" in batch and mode != "decode":
        ve = batch["vision_embeds"].to(x.dtype)
        x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
    if hasattr(model, "pos_embed"):
        if mode == "decode":
            x = x + model.pos_embed[cache_index][None, None, :]
        else:
            x = x + model.pos_embed[None, :s, :]
    if mode == "decode":
        positions = torch.full((b, s), cache_index, dtype=torch.int64, device=x.device)
    else:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    if cfg.mrope:
        positions = batch["positions"] if "positions" in batch else positions.expand(3, b, s)
    return x, positions


def encode(model: DecoderLM, batch: dict, cfg) -> torch.Tensor:
    """Whisper's encoder over the stub frame embeddings
    ``batch["encoder_frames"]`` (B, S_enc, D): the frames plus the sinusoidal
    positions, the encoder's blocks with bidirectional attention and no
    RoPE, then its final norm."""
    enc = model.encoder
    frames = batch["encoder_frames"].to(_DTYPES[cfg.dtype])
    b, s = frames.shape[0], frames.shape[1]
    x = frames + enc.pos_embed[None, :s, :]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    for blk in enc.layers:
        x = blk(x, None, cfg, positions=positions, mode="train", use_rope=False,
                causal=False)[0]
    return layers.apply_norm(enc.final_norm, x, cfg.norm_eps)


def forward(model: DecoderLM, lora: Optional[Tree], batch: dict, cfg, *, mode: str = "prefill",
            caches: Optional[Tree] = None, cache_index: Optional[int] = None,
            remat: bool = False, groups: int = 1):
    """Returns (logits, new_caches, moe_aux_loss).

    ``moe_aux_loss`` is the MoE load-balance loss summed over the layers,
    tail layers included (0 without experts): a scalar, or with ``groups``
    > 1 a (groups,) vector, one entry for each of ``groups`` equal,
    contiguous blocks of the batch rows, each routed on its own
    (``moe.apply_moe``; a local training phase passes one group a client,
    as the reference routes each client's own batch).

    ``train`` returns float32 logits at every position (B, S, V) and no
    caches; with ``remat`` each block's activations are recomputed in the
    backward pass (``torch.utils.checkpoint``), as the reference wraps its
    scanned block in ``jax.checkpoint``.  ``prefill`` returns the last
    position's float32 logits (B, 1, V) and caches sized to the prompt;
    ``decode`` takes one token per request (``batch["tokens"]`` (B, 1)) at
    position ``cache_index``, writes it into ``caches`` in place and
    returns them.  An encoder-decoder config runs ``encode`` on
    ``batch["encoder_frames"]`` outside decode (decode reads the cross
    caches) and no RoPE in the decoder; a VLM's ``batch`` may carry
    ``vision_embeds`` and ``positions`` (``_embed_inputs``).  ``lora`` is
    None, a 2-D adapter tree
    (``init_lora_params``, the merged path) or a view with a slot per
    request (``serve.pool.adapter_view``: a pool, or the client-stacked
    adapters of a local training step)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    x, positions = _embed_inputs(model, batch, cfg, mode, cache_index)
    encoder_out = None
    if cfg.encoder_decoder and mode != "decode":
        encoder_out = encode(model, batch, cfg)
    kw = dict(positions=positions, mode=mode, groups=groups, encoder_out=encoder_out,
              use_rope=not cfg.encoder_decoder)  # Whisper: learned positions, no RoPE
    new = []
    aux = torch.zeros((groups,), dtype=torch.float32, device=x.device)
    for blk, lo, c in zip(model.layers, _layer_trees(lora, cfg), _layer_caches(caches, cfg)):
        if remat and mode == "train":
            x, a = checkpoint(lambda h, lo_, blk_=blk: blk_(h, lo_, cfg, **kw)[::2],
                              x, lo, use_reentrant=False)
            nc = None
        else:
            x, nc, a = blk(x, lo, cfg, cache=c, cache_index=cache_index, **kw)
        if a is not None:
            aux = aux + a
        new.append(nc)
    x = layers.apply_norm(model.final_norm, x, cfg.norm_eps)
    if mode == "prefill":
        # Serving needs next-token logits only.
        x = x[:, -1:]
    head = model.lm_head if hasattr(model, "lm_head") else model.embed.T
    logits = layers.softcap(torch.matmul(x, head.to(x.dtype)).float(), cfg.logit_softcap)
    if mode == "prefill":
        unit = len(cfg.layer_pattern)
        n_grouped = cfg.n_pattern_groups * unit
        caches = {"groups": tuple(
            {key: _stack_states([c[key] for c in new[slot:n_grouped:unit]]) for key in new[slot]}
            for slot in range(unit)
        ), "tail": tuple(new[n_grouped:])}
    return logits, caches, (aux if groups > 1 else aux.reshape(()))


def _token_nll(logits: torch.Tensor, labels: torch.Tensor):
    """(B, S) next-token negative log-likelihoods (0 where the label is < 0)
    and the (B, S) float32 mask of counted tokens."""
    mask = labels >= 0
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          torch.where(mask, labels, -100).reshape(-1).long(),
                          ignore_index=-100, reduction="none")
    return nll.reshape(labels.shape), mask.to(torch.float32)


def loss_fn(model: DecoderLM, lora: Optional[Tree], batch: dict, cfg, *, remat: bool = False):
    """Next-token cross-entropy over float32 logits; labels < 0 are masked.
    Returns ``(total, {"ce", "aux"})`` with total = ce +
    ``cfg.router_aux_weight`` * aux, aux the MoE load-balance loss summed
    over the layers with the whole batch routed as one group (0 without
    experts)."""
    logits, _, aux = forward(model, lora, batch, cfg, mode="train", remat=remat)
    nll, mask = _token_nll(logits, batch["labels"])
    loss = torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0)
    return loss + cfg.router_aux_weight * aux, {"ce": loss, "aux": aux}


def client_losses(model: DecoderLM, lora: Optional[Tree], batch: dict, cfg, n_clients: int, *,
                  remat: bool = False) -> torch.Tensor:
    """``loss_fn``'s total for each of ``n_clients`` equal, contiguous blocks
    of the batch rows, as a (n_clients,) vector: client c's mean over its
    own counted tokens, plus ``cfg.router_aux_weight`` times its own MoE
    aux: each client's rows are routed as a group of their own, with their
    own capacity, as ``loss_fn`` on that client's rows alone routes them.
    With client-stacked adapters (one slot per client's rows), the gradient
    of the vector's sum gives each client's adapter exactly the gradient of
    its own loss."""
    logits, _, aux = forward(model, lora, batch, cfg, mode="train", remat=remat,
                             groups=n_clients)
    nll, mask = _token_nll(logits, batch["labels"])
    per = nll.reshape(n_clients, -1).sum(dim=1)
    count = mask.reshape(n_clients, -1).sum(dim=1)
    return per / torch.clamp_min(count, 1.0) + cfg.router_aux_weight * aux


def init_decode_caches(cfg, batch: int, cache_len: int, dtype=None, *, device="cuda") -> Tree:
    """Zeroed caches for ``cache_len`` positions, in the layout ``forward``
    returns: a sliding-window ring holds ``min(window, cache_len)``; with
    ``cfg.kv_quant`` the attention caches are int8 (``QuantKVCache``); an
    encoder-decoder config adds a cross cache of ``cfg.encoder_seq``
    positions to every layer.  On ``"meta"`` it allocates nothing."""
    dev = _device(device)
    dtype = dtype or _DTYPES[cfg.dtype]
    n = cfg.n_pattern_groups

    def one(kind):
        if kind in blocks.ATTN_KINDS:
            length = min(cfg.window_size, cache_len) if kind == "local_attn" else cache_len
            c = {"self": attn_cache(batch, length, cfg.n_kv_heads, cfg.head_dim_, dtype,
                                    quantized=cfg.kv_quant, device=dev)}
        elif kind == "rglru":
            c = {"self": rglru.init_lru_state(batch, cfg, dtype, device=dev)}
        else:
            c = {"self": ssd.init_ssm_state(batch, cfg, dtype, device=dev)}
        if cfg.encoder_decoder:
            c["cross"] = attn_cache(batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim_,
                                    dtype, device=dev)
        return c

    return {"groups": tuple(
        {key: _stack_states([state] * n) for key, state in one(kind).items()}
        for kind in cfg.layer_pattern
    ), "tail": tuple(one(kind) for kind in _tail_kinds(cfg))}


def extend_caches(caches: Tree, extra: int, cfg) -> Tree:
    """Room for ``extra`` decode positions: prefill emits caches sized to the
    prompt, decode writes one position per step in place.

    * Full-attention KV buffers gain ``extra`` zero positions on the
      sequence axis (all four tensors of an int8 ``QuantKVCache``).
    * A sliding-window ring shorter than the window (a prompt shorter than
      it) grows to ``min(window, length + extra)`` zero-padded slots, the
      size ``init_decode_caches`` gives, bf16 or int8; a ring already
      ``window`` long is kept.  Decode at position t then writes slot
      t % ring and evicts only keys that have left the window, so decode
      equals the train-mode forward at every prompt length.  The reference
      pads no ring: after a prompt shorter than the window its decode
      writes slot t % prompt length and evicts keys still inside the
      window, so there the port's decode departs from the reference's by
      design (ROADMAP.md queue 3).
    * Recurrent states (``"ssd"``, ``"rglru"``) and cross caches (the
      encoder's K and V, every slot of which decode attends) are passed
      through.

    Allocated once per batch, group slots and tail alike."""
    def pad(t, length):
        if length == t.shape[-3]:
            return t
        out = t.new_zeros((*t.shape[:-3], length, *t.shape[-2:]))
        out[..., : t.shape[-3], :, :] = t
        return out

    def fix(kind, cache):
        state = cache["self"]
        if kind == "attn":
            length = state[0].shape[-3] + extra
        elif kind == "local_attn":
            have = state[0].shape[-3]
            length = have if have >= cfg.window_size else min(cfg.window_size, have + extra)
        else:
            return cache
        return dict(cache, self=type(state)(*(pad(t, length) for t in state)))

    return {"groups": tuple(fix(kind, g) for kind, g in zip(cfg.layer_pattern, caches["groups"])),
            "tail": tuple(fix(kind, c) for kind, c in zip(_tail_kinds(cfg), caches["tail"]))}


def decode_step(model, lora, tokens, caches, cache_index: int, cfg):
    """serve_step: one token (B, 1) against caches; returns (logits, caches)."""
    logits, caches, _ = forward(model, lora, {"tokens": tokens}, cfg, mode="decode",
                                caches=caches, cache_index=cache_index)
    return logits, caches


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


__all__ = [
    "DecoderLM", "Encoder", "client_losses", "decode_step", "embed_tokens", "encode",
    "extend_caches", "forward",
    "init_decode_caches", "init_lora_params", "init_params", "loss_fn", "param_count",
]
