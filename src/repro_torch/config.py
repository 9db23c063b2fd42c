"""Config system: model / LoRA / shape / federated / mesh configuration.

Port of ``repro/config.py``, kept as a copy (the port imports nothing of
the JAX package): plain frozen dataclasses with JSON (de)serialization.
Architecture configs in ``repro_torch.configs`` construct ``ModelConfig``
instances; the launchers consume them by ``--arch <id>``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

try:
    import orjson
except ImportError:  # stdlib fallback: same bytes-in/bytes-out contract
    orjson = None
    import json as _json


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    # Which projections carry adapters.  The paper fine-tunes Q and V only.
    targets: Tuple[str, ...] = ("q", "v")
    dtype: str = "float32"

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


@dataclass(frozen=True)
class ModelConfig:
    """One architecture.  ``layer_pattern`` lists the mixer of each layer in a
    repeating unit; layers = pattern * (n_layers // len(pattern)) + leftover.

    Mixer kinds: "attn" (full causal), "local_attn" (sliding window),
    "ssd" (Mamba-2), "rglru" (Griffin recurrent block).
    """

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    layer_pattern: Tuple[str, ...] = ("attn",)
    # --- attention ---
    window_size: int = 4096  # for local_attn mixers
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_pct: float = 1.0  # stablelm partial rotary
    mrope: bool = False  # qwen2-vl multimodal 3-axis RoPE
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # per-axis rotary dims (halves)
    logit_softcap: float = 0.0  # gemma-style final logit soft-capping (0 = off)
    # --- ffn ---
    ffn_kind: str = "swiglu"  # swiglu | geglu | gelu (0 d_ff -> no ffn)
    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss weight
    # --- ssm (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # --- rglru (griffin) ---
    lru_width: int = 0  # 0 -> d_model
    # --- encoder-decoder (whisper) ---
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper-medium: 30s audio -> 1500 frames
    # --- modality frontend stub ---
    frontend: Optional[str] = None  # None | "audio" | "vision"
    n_vision_tokens: int = 0  # vlm: leading patch-embedding positions
    # --- norm / embedding ---
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d_model)
    # --- lora ---
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    # --- serving ---
    kv_quant: bool = False  # int8 KV cache (decode memory-term optimization)
    # --- numerics ---
    dtype: str = "bfloat16"  # activation/weight dtype on the mesh
    # provenance
    source: str = ""  # citation for the config

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim_

    @property
    def n_pattern_groups(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def n_tail_layers(self) -> int:
        return self.n_layers - self.n_pattern_groups * len(self.layer_pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True if no mixer needs a full-length KV cache (long_500k eligible)."""
        return all(k in ("ssd", "rglru", "local_attn") for k in self.layer_pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: <=2 pattern units,
        d_model <= 512, <= 4 experts (the reference's ``reduced``)."""
        unit = len(self.layer_pattern)
        d_model = min(self.d_model, 256)
        head_dim = 32 if self.head_dim else 0
        n_heads = 4
        n_kv_heads = min(self.n_kv_heads, n_heads)
        if self.n_kv_heads == self.n_heads:
            n_kv_heads = n_heads
        elif self.n_kv_heads == 1:
            n_kv_heads = 1
        else:
            n_kv_heads = 2
        kw = dict(
            n_layers=max(unit, 2 if unit == 1 else unit),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv_heads,
            head_dim=head_dim,
            d_ff=0 if self.d_ff == 0 else 512,
            vocab_size=min(self.vocab_size, 512),
            window_size=min(self.window_size, 32),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 32),
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=16 if self.ssm_state else self.ssm_chunk,
            lru_width=min(self.lru_width, 256) if self.lru_width else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16),
            n_vision_tokens=min(self.n_vision_tokens, 8),
            mrope_sections=(4, 6, 6) if self.mrope else self.mrope_sections,
            lora=LoRAConfig(rank=4, targets=self.lora.targets),
            dtype="float32",
        )
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


@dataclass(frozen=True)
class FedConfig:
    n_clients: int = 16
    clients_per_round: int = 16  # full participation by default (paper setting)
    local_steps: int = 4
    local_lr: float = 1e-4
    local_optimizer: str = "adam"  # sgd | adam | adamw
    weight_decay: float = 0.0
    # client-level heterogeneity methods (composable with any aggregator)
    fedprox_mu: float = 0.0
    scaffold: bool = False
    moon_mu: float = 0.0
    # data partition
    dirichlet_alpha: float = 0.3
    rounds: int = 50
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """The reference's production mesh, as data: (16, 16) over
    ("data", "model"), or (2, 16, 16) over ("pod", "data", "model")."""

    multi_pod: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def client_axes(self) -> Tuple[str, ...]:
        return ("pod", "data") if self.multi_pod else ("data",)

    @property
    def n_clients(self) -> int:
        n = 1
        for a, s in zip(self.axes, self.shape):
            if a in self.client_axes:
                n *= s
        return n


def to_json(cfg) -> bytes:
    if orjson is None:
        return _json.dumps(dataclasses.asdict(cfg), indent=2).encode()
    return orjson.dumps(dataclasses.asdict(cfg), option=orjson.OPT_INDENT_2)


def _from_dict(cls, d):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in d.items():
        if k not in fields:
            continue
        f = fields[k]
        if f.name == "lora" and isinstance(v, dict):
            v = LoRAConfig(**{k2: tuple(v2) if k2 == "targets" else v2 for k2, v2 in v.items()})
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return cls(**kw)


def model_config_from_json(data: bytes) -> ModelConfig:
    if orjson is None:
        return _from_dict(ModelConfig, _json.loads(data))
    return _from_dict(ModelConfig, orjson.loads(data))
