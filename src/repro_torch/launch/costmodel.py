"""Analytic per-chip cost model for the roofline terms (port of
``repro/launch/costmodel.py``).

The port runs eagerly and emits no compiled artifact, so every FLOP, byte
and collective figure of a (config, shape, mesh, step) tuple comes from
these closed forms, copied from the reference.  ``step_costs`` gives the
per-chip FLOPs, HBM bytes and collective bytes of one step;
``serve_gather_costs`` and ``mesh_agg_costs`` turn theirs into
microseconds with rates and per-call costs that are keyword arguments:
their defaults are the card's (``roofline.py``: the H100 SXM5 80GB's data
sheet) and the host costs of a kernel call and of an aggregation call on
the card, measured by ``chip_smoke.py``.  (The reference's own constants
there are fits to its CPU container; pass them to reproduce its numbers.)

All quantities are PER CHIP.  Conventions:
  c      = number of client/batch shards  (data [* pod] axis sizes)
  m      = model-axis size
  T_loc  = tokens per chip = global_tokens / c   (model axis replicates tokens)
  A matmul with its weight sharded on the model axis contributes
  2 * T_loc * d_in * d_out / m FLOPs; an unsharded (replicated) weight
  contributes 2 * T_loc * d_in * d_out.

Training multiplier: the base model is FROZEN (LoRA-only training), so the
backward pass computes activation gradients (~1x forward) but almost no
weight gradients; with remat the forward is recomputed once more:
  train factor = 1 (fwd) + 1 (dgrad) + 1 (remat) = 3x forward FLOPs.
(MODEL_FLOPS keeps 6ND / 2ND, so useful_flops_ratio can exceed what full
fine-tuning would show.)  One card is the mesh with m = c = 1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.launch import roofline

# The card's rates in the units of the closed forms: FLOP/us and bytes/us.
CARD_FLOPS_PER_US = roofline.PEAK_FLOPS / 1e6
CARD_HBM_BYTES_PER_US = roofline.HBM_BW / 1e6
CARD_LINK_BYTES_PER_US = roofline.LINK_BW / 1e6
# Host cost of one kernel wrapper call (us): path C's gathered LoRA
# projection at decode, (8, 2048) x (2048, 2048), rank 8, dispatched while
# the card sleeps.  Measured by chip_smoke.py (``card_constants``) on an
# H100 80GB HBM3 at 700 W (PERF.md §5).
KERNEL_CALL_US = 59.99
# Host floor of one warm aggregation call (us): a warm ``AggSession`` step
# of path G's configuration (fedrpca, subspace SVT and carry, 50 ADMM
# iterations) on one 64 x 4 module of 8 clients, where the card's work is
# small; the wall time to a synchronize, median of 5.  Measured by
# chip_smoke.py on the same card (PERF.md §5).
AGG_CALL_US = 34764.0


def _ssd_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    return dict(
        d_inner=d_inner,
        n_heads=d_inner // cfg.ssm_head_dim,
        conv_dim=d_inner + 2 * cfg.ssm_state,
    )


@dataclasses.dataclass
class CostBreakdown:
    flops: Dict[str, float]
    hbm_bytes: Dict[str, float]
    collective_bytes: Dict[str, float]

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    @property
    def total_hbm_bytes(self) -> float:
        return sum(self.hbm_bytes.values())

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _div(x: int, size: int) -> float:
    """Model-axis division only when the layout actually shards (divisible)."""
    return x / size if x % size == 0 else float(x)


def step_costs(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    model_size: int = 16,
    client_shards: int = 16,
    local_steps: int = 1,
    rpca_iters: int = 30,
    n_clients: int | None = None,
    aggregator: str = "fedrpca",
    remat: bool = True,
    attn_schedule: str = "causal_half",  # matches the triangular flash schedule;
    # "full_blocks" reproduces the pre-optimization masked-loop baseline
    dtype_bytes: int = 2,
    policy: str = "tp",  # tp | tp_fsdp | dp | ep_replicated (partitioning.py)
) -> CostBreakdown:
    m = model_size
    c = client_shards
    if policy == "dp":
        # weights replicated; ALL chips split the batch (clients x model axis)
        c = c * m
        m = 1
    if shape.global_batch % max(c, 1) != 0:
        c = 1  # replicated batch (e.g. long_500k B=1): every chip holds it
    n_clients = n_clients or client_shards
    d = cfg.d_model
    hd = cfg.head_dim_
    q_dim, kv_dim = cfg.q_dim, cfg.kv_dim
    seq = shape.seq_len
    is_train = shape.kind == "train"
    is_decode = shape.kind == "decode"
    tokens_global = shape.global_batch * (1 if is_decode else seq)
    t_loc = tokens_global / c
    ctx = seq  # attention context length

    train_mult = (3.0 if remat else 2.0) if is_train else 1.0
    if is_train:
        train_mult *= local_steps

    fl: Dict[str, float] = {}
    hbm: Dict[str, float] = {}
    coll: Dict[str, float] = {}

    def mm(tokens, d_in, d_out, sharded=True):
        return 2.0 * tokens * d_in * _div(d_out, m) if sharded else 2.0 * tokens * d_in * d_out

    # --- per-layer mixer/ffn costs ---
    unit = cfg.layer_pattern
    n_per_kind: Dict[str, int] = {}
    for i in range(cfg.n_layers):
        k = unit[i % len(unit)]
        n_per_kind[k] = n_per_kind.get(k, 0) + 1

    attn_flops = 0.0
    for kind, n_l in n_per_kind.items():
        if kind in ("attn", "local_attn"):
            proj = (
                mm(t_loc, d, q_dim)
                + 2 * mm(t_loc, d, kv_dim)
                + 2.0 * t_loc * _div(q_dim, m) * d  # o-proj (row-parallel)
            )
            if is_decode:
                s_ctx = min(cfg.window_size, ctx) if kind == "local_attn" else ctx
            elif kind == "local_attn":
                s_ctx = min(cfg.window_size + 512, ctx)  # blocks touched per query
            else:
                s_ctx = ctx if attn_schedule == "full_blocks" else (ctx / 2 + 256)
            score_pv = 2.0 * 2.0 * t_loc * s_ctx * _div(cfg.n_heads, m) * hd
            attn_flops += n_l * (proj + score_pv)
            # Decode reads the whole KV cache every step: the memory term.
            if is_decode:
                cache_ctx = min(cfg.window_size, ctx) if kind == "local_attn" else ctx
                # int8 KV quantization: 1 byte mantissa + fp16 scale per head
                kv_b = (1.0 + 2.0 / hd) if getattr(cfg, "kv_quant", False) else dtype_bytes
                hbm[f"kv_cache_read/{kind}"] = hbm.get(f"kv_cache_read/{kind}", 0.0) + (
                    n_l * (shape.global_batch / c) * cache_ctx
                    * _div(cfg.n_kv_heads * hd, m) * 2 * kv_b
                )
        elif kind == "ssd":
            sd = _ssd_dims(cfg)
            per = (
                mm(t_loc, d, sd["d_inner"] + sd["conv_dim"] + sd["n_heads"], sharded=False)
                + 2.0 * t_loc * sd["conv_dim"] * cfg.conv_width
                + 2.0 * t_loc * (1 if is_decode else cfg.ssm_chunk) * cfg.ssm_state  # scores
                + 2.0 * t_loc * (1 if is_decode else cfg.ssm_chunk) * sd["d_inner"]  # y_intra
                + 4.0 * t_loc * cfg.ssm_state * sd["d_inner"]  # states + y_inter
                + 2.0 * t_loc * sd["d_inner"] * _div(d, m)  # out_proj
                + 8.0 * t_loc * sd["d_inner"]  # gate/norm
            )
            attn_flops += n_l * per
        elif kind == "rglru":
            w = cfg.lru_width or d
            per = (
                2 * mm(t_loc, d, w)  # proj_x + proj_gate
                + 2 * mm(t_loc, w, w)  # gate_a + gate_x
                + 2.0 * t_loc * w * cfg.conv_width
                + 10.0 * t_loc * w  # recurrence + gating elementwise
                + 2.0 * t_loc * _div(w, m) * d  # out_proj
            )
            attn_flops += n_l * per
    fl["mixers"] = attn_flops * train_mult

    # FFN / MoE (every layer when d_ff > 0).
    if cfg.d_ff > 0:
        if cfg.n_experts:
            if policy == "ep_replicated":
                expert_div = m if cfg.d_ff % m == 0 else 1
            elif policy == "moe2d":
                expert_div = m * client_shards  # E over model, d_ff over data
            else:
                expert_div = m
            per = (
                2.0 * t_loc * d * cfg.n_experts  # router (replicated)
                + 3.0 * 2.0 * t_loc * cfg.top_k * d * cfg.d_ff / expert_div
            )
        else:
            n_mats = 3 if cfg.ffn_kind in ("swiglu", "geglu") else 2
            per = n_mats * mm(t_loc, d, cfg.d_ff)
        fl["ffn"] = cfg.n_layers * per * train_mult

    # Embedding + LM head (+ loss).
    head_tokens = shape.global_batch / c if shape.kind != "train" else t_loc
    fl["lm_head"] = 2.0 * head_tokens * d * _div(cfg.vocab_size, m) * train_mult
    if is_train:
        fl["loss_softmax"] = 5.0 * t_loc * _div(cfg.vocab_size, m) * local_steps

    # Whisper encoder + cross attention.
    if cfg.encoder_decoder:
        t_enc = (shape.global_batch / c) * cfg.encoder_seq
        enc_per = (
            mm(t_enc, d, q_dim) + 2 * mm(t_enc, d, kv_dim)
            + 2.0 * t_enc * _div(q_dim, m) * d
            + 2.0 * 2.0 * t_enc * cfg.encoder_seq * _div(cfg.n_heads, m) * hd
            + 2 * mm(t_enc, d, cfg.d_ff)
        )
        fl["encoder"] = cfg.n_encoder_layers * enc_per * (train_mult if is_train else 1.0)
        dec_t = shape.global_batch / c if is_decode else t_loc
        cross_per = (
            mm(dec_t, d, q_dim) + 2.0 * dec_t * _div(q_dim, m) * d
            + (0.0 if is_decode else 2 * mm(t_enc, d, kv_dim))
            + 2.0 * 2.0 * dec_t * cfg.encoder_seq * _div(cfg.n_heads, m) * hd
        )
        fl["cross_attn"] = cfg.n_layers * cross_per * train_mult

    # FedRPCA server step (train only; computed replicated on every chip).
    if is_train and aggregator == "fedrpca":
        r = cfg.lora.rank
        rpca = 0.0
        for kind, n_l in n_per_kind.items():
            if kind in ("attn", "local_attn"):
                dims = [(d, r), (r, kv_dim)] if "v" in cfg.lora.targets else []
                dims += [(d, r), (r, q_dim)] if "q" in cfg.lora.targets else []
            elif kind == "ssd":
                sd = _ssd_dims(cfg)
                dims = [(d, r), (r, sd["d_inner"] + sd["conv_dim"] + sd["n_heads"]),
                        (sd["d_inner"], r), (r, d)]
            else:
                w = cfg.lru_width or d
                dims = [(d, r), (r, w), (w, r), (r, d)]
            for d1, d2 in dims:
                n_vec = d1 * d2
                rpca += n_l * rpca_iters * (4.0 * n_vec * n_clients**2 + 26.0 * n_clients**3)
        fl["rpca_server"] = rpca

    # ------------------------------------------------------------------ HBM
    params_local = _params_local_bytes(
        cfg, m, dtype_bytes, policy=policy, fsdp_size=client_shards
    )
    weight_passes = (3.0 if remat else 2.0) if is_train else 1.0
    if is_train:
        weight_passes *= local_steps
    hbm["weights"] = params_local * weight_passes
    if policy == "tp_fsdp":
        params_local /= max(client_shards, 1)  # resident shard after ZeRO-3
    fsdp = policy == "tp_fsdp"
    if fsdp:
        # Weights resident sharded over the data axes; gathered per pass.
        hbm["weights"] = params_local * weight_passes  # traffic unchanged
        coll["fsdp_weight_allgather"] = (
            params_local * (client_shards - 1) / max(client_shards, 1) * weight_passes
        )
    act_tokens = shape.global_batch / c if is_decode else t_loc
    hbm["activations"] = 12.0 * cfg.n_layers * act_tokens * d * dtype_bytes * train_mult
    hbm["logits"] = head_tokens * _div(cfg.vocab_size, m) * 4.0 * (3.0 if is_train else 1.0)
    if cfg.encoder_decoder and not is_decode:
        hbm["encoder_act"] = (
            12.0 * cfg.n_encoder_layers
            * (shape.global_batch / c) * cfg.encoder_seq * d * dtype_bytes
        )
    if is_decode and cfg.encoder_decoder:
        hbm["cross_cache_read"] = (
            cfg.n_layers * (shape.global_batch / c) * cfg.encoder_seq
            * _div(kv_dim, m) * 2 * dtype_bytes
        )
    if is_train and aggregator == "fedrpca":
        lora_b = _lora_bytes(cfg, 4)
        hbm["rpca"] = 6.0 * rpca_iters * lora_b * n_clients / max(c, 1)

    # ----------------------------------------------------------- collectives
    ar = lambda nbytes: 2.0 * nbytes * (m - 1) / m  # ring all-reduce
    ag_clients = lambda nbytes: nbytes * (c - 1) / c if c > 1 else 0.0

    # Row-parallel partial-sum all-reduces (o-proj, down/out-proj) per layer,
    # forward + dgrad.
    n_rowpar = 0
    for kind, n_l in n_per_kind.items():
        n_rowpar += n_l * (1 if kind in ("attn", "local_attn") else 1)
    if cfg.d_ff > 0 and not cfg.n_experts:
        n_rowpar += cfg.n_layers
    act_bytes = act_tokens * d * dtype_bytes
    bwd_factor = 2.0 if is_train else 1.0
    coll["rowparallel_allreduce"] = n_rowpar * ar(act_bytes) * bwd_factor * (
        local_steps if is_train else 1
    )
    if cfg.encoder_decoder and not is_decode:
        enc_act = (shape.global_batch / c) * cfg.encoder_seq * d * dtype_bytes
        coll["encoder_allreduce"] = (cfg.n_encoder_layers + cfg.n_layers) * ar(enc_act)
    # Vocab-sharded embedding lookup -> all-reduce of the gathered activations.
    coll["embed_allreduce"] = ar(act_bytes) * (local_steps if is_train else 1)
    if cfg.n_experts:
        if policy == "ep_replicated":
            # Experts ffn-sharded like a dense MLP: dispatch stays local, the
            # down-proj contributes one more row-parallel all-reduce/layer.
            coll["rowparallel_allreduce"] = coll.get("rowparallel_allreduce", 0.0) + (
                cfg.n_layers * ar(act_bytes) * bwd_factor
                * (local_steps if is_train else 1)
            )
        else:
            a2a = t_loc * max(cfg.top_k, 1) * d * dtype_bytes * (m - 1) / max(m, 1)
            coll["moe_all_to_all"] = 2.0 * cfg.n_layers * a2a * (
                (3.0 if is_train else 1.0) * (local_steps if is_train else 1)
            )
            if policy == "moe2d":
                # down-proj partial sums all-reduce over the data axis
                buf = t_loc * max(cfg.top_k, 1) * d * dtype_bytes
                coll["moe2d_down_allreduce"] = cfg.n_layers * (
                    2.0 * buf * (client_shards - 1) / max(client_shards, 1)
                ) * ((3.0 if is_train else 1.0) * (local_steps if is_train else 1))
    if is_train:
        lora_b = _lora_bytes(cfg, 4)
        coll["delta_allgather"] = ag_clients(lora_b * n_clients)
        if policy == "dp":
            # per-client LoRA grads sync over the model axis every local step
            mm_sz = model_size
            coll["dp_lora_allreduce"] = (
                2.0 * lora_b * (mm_sz - 1) / max(mm_sz, 1) * local_steps
            )

    return CostBreakdown(flops=fl, hbm_bytes=hbm, collective_bytes=coll)


def serve_gather_costs(
    *,
    n_requests: int,
    seq_len: int,
    n_adapters: int,
    d_in: int,
    d_out: int,
    rank: int,
    block_m: int = 16,
    dtype_bytes: int = 4,
    bw_strided: float = CARD_HBM_BYTES_PER_US,
    bw_stream: float = CARD_HBM_BYTES_PER_US,
    flops_peak: float = CARD_FLOPS_PER_US,
    overhead_per_req: float = KERNEL_CALL_US,
    overhead_gathered: float = KERNEL_CALL_US,
) -> Dict[str, float]:
    """Analytic cost of one multi-tenant LoRA projection, per serving path.

    Models the three serve-bench paths (benchmarks ``mode:"serve"`` cells):

      per_request — materialize each row's (A, B) from the pool:
        gather bytes M * (K*R + R*N), LoRA compute as M rank-R GEMVs.
      gathered — sorted/padded segment layout (``kernels.segment_layout``):
        adapters gathered once per block_m row-tile, LoRA compute as
        real-GEMM tiles over the padded row count
        M_pad = M + n_seg * (block_m - 1) worst case, where
        n_seg = min(n_adapters, n_requests) distinct adapters can appear.
      merged — one averaged adapter: no gather, no padding (the baseline
        that serves every tenant the same adapter).

    The returned ``gathered_vs_per_request`` ratio (>1 = gathered wins)
    weighs the factor-block_m gather-traffic saving against the padding
    compute waste.

    Rates in bytes/us (``bw_strided`` for the per-request gather,
    ``bw_stream`` for contiguous tiles) and FLOP/us (``flops_peak``), fixed
    costs in us per call of each path: the card's by default (HBM and bf16
    peaks, ``KERNEL_CALL_US`` for each path, one wrapper call each).  The
    reference fit its CPU container: 1e4, 3e4, 5e4, 50 and 250.
    """
    m_rows = n_requests * seq_len
    adapter_bytes = (d_in * rank + rank * d_out) * dtype_bytes
    lora_flops_per_row = 2.0 * rank * (d_in + d_out)

    n_seg = min(n_adapters, n_requests)
    n_tiles = (m_rows + n_seg * (block_m - 1) + block_m - 1) // block_m
    m_pad = n_tiles * block_m

    per_request = {
        "gather_bytes": float(m_rows) * adapter_bytes,
        "lora_flops": m_rows * lora_flops_per_row,
    }
    layout_bytes = 4.0 * m_rows * (d_in + d_out) * dtype_bytes
    gathered = {
        "gather_bytes": float(n_tiles) * adapter_bytes + layout_bytes,
        "lora_flops": m_pad * lora_flops_per_row,
    }
    merged = {"gather_bytes": 0.0, "lora_flops": m_rows * lora_flops_per_row}

    def us(path, bw, overhead):
        return max(path["gather_bytes"] / bw, path["lora_flops"] / flops_peak) + overhead

    per_request["us"] = us(per_request, bw_strided, overhead_per_req)
    gathered["us"] = us(gathered, bw_stream, overhead_gathered)
    merged["us"] = us(merged, bw_stream, 0.0)
    return {
        "per_request": per_request,
        "gathered": gathered,
        "merged": merged,
        "m_pad": float(m_pad),
        "gathered_vs_per_request": per_request["us"] / gathered["us"],
        "gathered_wins": per_request["us"] > gathered["us"],
    }


def serve_crossover_batch(
    *, n_adapters: int, seq_len: int = 4, d_in: int = 512, d_out: int = 512,
    rank: int = 16, block_m: int = 16, max_batch: int = 1024, **rates,
) -> int | None:
    """Smallest request count where the gathered-pool path is predicted to
    beat per-request materialization (None if it never does by max_batch).
    ``rates`` go to ``serve_gather_costs``."""
    for b in range(1, max_batch + 1):
        if serve_gather_costs(
            n_requests=b, seq_len=seq_len, n_adapters=n_adapters,
            d_in=d_in, d_out=d_out, rank=rank, block_m=block_m, **rates,
        )["gathered_wins"]:
            return b
    return None


def _params_local_bytes(
    cfg: ModelConfig, m: int, dtype_bytes: int, *, policy: str = "tp", fsdp_size: int = 1
) -> float:
    """Per-chip resident base parameter bytes under the chosen layout."""
    d, hd = cfg.d_model, cfg.head_dim_
    total = _div(cfg.vocab_size, m) * d  # embed
    if not cfg.tie_embeddings:
        total += d * _div(cfg.vocab_size, m)
    per_layer = {}
    for kind in set(cfg.layer_pattern):
        if kind in ("attn", "local_attn"):
            p = d * _div(cfg.q_dim, m) + 2 * d * _div(cfg.kv_dim, m) + _div(cfg.q_dim, m) * d
        elif kind == "ssd":
            sd = _ssd_dims(cfg)
            p = d * (sd["d_inner"] + sd["conv_dim"] + sd["n_heads"]) + sd["d_inner"] * _div(d, m)
        else:
            w = cfg.lru_width or d
            p = 2 * d * _div(w, m) + 2 * _div(w, m) * w + _div(w, m) * d
        per_layer[kind] = p
    unit = cfg.layer_pattern
    for i in range(cfg.n_layers):
        total += per_layer[unit[i % len(unit)]]
    if cfg.d_ff:
        if cfg.n_experts:
            expert_bytes = 3 * _div(cfg.n_experts, m) * d * cfg.d_ff
            if policy == "moe2d" and cfg.d_ff % fsdp_size == 0:
                expert_bytes /= fsdp_size
            total += cfg.n_layers * (d * cfg.n_experts + expert_bytes)
        else:
            n_mats = 3 if cfg.ffn_kind in ("swiglu", "geglu") else 2
            total += cfg.n_layers * n_mats * d * _div(cfg.d_ff, m)
    if cfg.encoder_decoder:
        enc = cfg.n_encoder_layers * (
            d * _div(cfg.q_dim, m) + 2 * d * _div(cfg.kv_dim, m) + _div(cfg.q_dim, m) * d
            + 2 * d * _div(cfg.d_ff, m)
        )
        cross = cfg.n_layers * (
            d * _div(cfg.q_dim, m) + 2 * d * _div(cfg.kv_dim, m) + _div(cfg.q_dim, m) * d
        )
        total += enc + cross
    return total * dtype_bytes


def _lora_bytes(cfg: ModelConfig, dtype_bytes: int = 4) -> float:
    d, r = cfg.d_model, cfg.lora.rank
    total = 0.0
    for kind in cfg.layer_pattern:
        if kind in ("attn", "local_attn"):
            per = 0
            per += (d * r + r * cfg.q_dim) if "q" in cfg.lora.targets else 0
            per += (d * r + r * cfg.kv_dim) if "v" in cfg.lora.targets else 0
        elif kind == "ssd":
            sd = _ssd_dims(cfg)
            per = d * r + r * (sd["d_inner"] + sd["conv_dim"] + sd["n_heads"]) + sd[
                "d_inner"
            ] * r + r * d
        else:
            w = cfg.lru_width or d
            per = d * r + r * w + w * r + r * d
        total += per
    total *= cfg.n_layers / len(cfg.layer_pattern)
    if cfg.encoder_decoder:  # cross-attention adapters
        total += cfg.n_layers * ((cfg.d_model * r + r * cfg.q_dim) + (cfg.d_model * r + r * cfg.kv_dim))
    return total * dtype_bytes


def mesh_agg_costs(
    *,
    n_modules: int,
    padded_vec: int,
    cohort: int,
    shards: int,
    rpca_iters: int = 30,
    svt_rank: int = 8,
    svt_sweeps: int = 2,
    warm: bool = True,
    dtype_bytes: int = 4,
    shared_host_core: bool = True,
    fused_tail: bool = False,
    overlap: bool = False,
    flops_peak: float = CARD_FLOPS_PER_US,
    bw_hbm: float = CARD_HBM_BYTES_PER_US,
    bw_coll: float = CARD_LINK_BYTES_PER_US,
    coll_overhead_us: float = KERNEL_CALL_US,
    dispatch_us: float = AGG_CALL_US,
) -> Dict[str, float]:
    """Analytic round cost of one mesh-sharded RPCA bucket.

    Per ADMM iteration the client-axis-sharded loop does, per shard of
    ``c_loc = ceil(cohort / shards)`` columns (ragged cohorts zero-pad the
    client axis, so every shard carries the padded slice — masked columns
    cost the same bytes/FLOPs as live ones):

      column-local tail — shrink / residual / dual on (B, d1, c_loc) blocks
        (pure elementwise, zero communication);
      subspace SVT — per power sweep one (B, d1, r) all-reduce of the
        projected factor W = X V plus an r x r Gram reduce, with the
        2 * B * d1 * c_loc * r matmul FLOPs staying shard-local; a final
        r x r Rayleigh-Ritz solve replicated.

    ``warm=True`` models the steady-state carry path (sweep-cut to one
    sweep, zero eigh fallbacks — the acceptance criterion); ``warm=False``
    models the cold/exact path, whose per-iteration all-gather of X
    (B * d1 * cohort bytes) and replicated d2 x d2 eigh are the non-scaling
    terms the subspace path exists to avoid.

    ``fused_tail=True`` models the shard-local fused tail (the port's
    ``subspace_apply_factored`` kernel): the factored L = F Vr^T apply,
    shrink, residual, and dual update execute in one pass over the
    (B, d1, c_loc) slice instead of ~5 separate HBM round-trips, cutting the
    tail's HBM traffic to one read+write of the operand set.  FLOPs are
    unchanged (same math, fewer materialisations).

    ``overlap=True`` models the chunked-psum schedule (``mesh_overlap``):
    the bucket axis is split so chunk k+1's sweep all-reduce issues while
    chunk k's tail executes, hiding the smaller of compute/comm time:
    ``us = max(compute, comm) + dispatch`` instead of their sum.

    ``shared_host_core=True`` divides the per-shard FLOP peak by the shard
    count: the shards share one device (the port's ``make_host_mesh`` puts
    every shard on the one card of a one-card machine), so sharding buys
    *memory headroom and the collective schedule*, not compute.  Set it
    False for one device a shard, where per-shard compute time drops 1/n
    and the comm/compute crossover appears; ``mesh_crossover_shards`` sweeps
    it.

    Rates: ``flops_peak`` FLOP/us, ``bw_hbm`` and ``bw_coll`` bytes/us; the
    fixed costs ``coll_overhead_us`` per collective and ``dispatch_us`` per
    aggregation call.  The defaults are the card's (bf16 peak, HBM, NVLink
    each way, ``KERNEL_CALL_US``, ``AGG_CALL_US``); the reference fit its
    CPU container: 5e4, 3e4, 2e4, 150 and 6000.

    Returns per-round totals: local flops/bytes per shard, all-reduced and
    gathered bytes, collective count, predicted peak bytes per shard, and
    the ``us`` roofline estimate split into compute/comm.
    """
    if shards <= 0:
        raise ValueError(f"shards must be positive, got {shards}")
    b, d1 = float(n_modules), float(padded_vec)
    c_loc = float(-(-cohort // shards))  # ceil: ragged cohorts pad, not refuse
    # Ceil cap, matching rpca.subspace_rank: an odd cohort of c columns
    # carries rank (c+1)//2, not c//2 (the nc=7 warm-carry fallback fix).
    r = float(max(1, min(svt_rank, (cohort + 1) // 2)) if cohort > 1 else 1)
    sweeps_eff = 1.0 if warm else float(max(svt_sweeps, 1))
    applies = sweeps_eff + 1.0  # power sweeps + the final Ritz G @ V

    tail_flops = 10.0 * b * d1 * c_loc
    sweep_flops = applies * 4.0 * b * d1 * c_loc * r
    small_flops = 4.0 * b * c_loc * r * r + 30.0 * b * r**3
    l_flops = 2.0 * b * d1 * r * r + 2.0 * b * d1 * c_loc * r
    local_flops = tail_flops + sweep_flops + small_flops + l_flops
    if fused_tail:
        # Fused tail: shrink/residual/dual plus the factored L-apply stream
        # through once — the tail's ~5 intermediate HBM round-trips collapse
        # to a single read+write of M/L/S/Y, leaving only the sweep's X reads
        # as repeat traffic.
        local_bytes = (3.0 + 1.0 * applies) * b * d1 * c_loc * dtype_bytes
    else:
        local_bytes = (8.0 + 2.0 * applies) * b * d1 * c_loc * dtype_bytes

    ring = 2.0 * (shards - 1) / shards if shards > 1 else 0.0
    allreduce_bytes = applies * b * d1 * r * dtype_bytes * ring
    allreduce_bytes += (applies + 1.0) * b * r * r * dtype_bytes * ring
    n_collectives = (2.0 * applies + 1.0) if shards > 1 else 0.0
    gather_bytes = 0.0
    if not warm:
        # Exact path: gather X, form the d2 x d2 Gram and eigh REPLICATED —
        # neither divides by the shard count.
        gather_bytes = b * d1 * cohort * dtype_bytes * (
            (shards - 1) / shards if shards > 1 else 0.0
        )
        local_flops += 2.0 * b * d1 * cohort**2 + 26.0 * b * cohort**3
        local_bytes += 2.0 * b * d1 * cohort * dtype_bytes
        n_collectives += 1.0 if shards > 1 else 0.0

    it = float(rpca_iters)
    local_flops *= it
    local_bytes *= it
    allreduce_bytes *= it
    gather_bytes *= it
    n_collectives *= it

    # Resident per shard: M/S/Y/L + X + two tail temporaries, plus the
    # carried basis; the cold path transiently adds the gathered X and Gram.
    peak = 8.0 * b * d1 * c_loc * dtype_bytes + b * c_loc * r * dtype_bytes
    if not warm:
        peak += b * d1 * cohort * dtype_bytes + b * cohort**2 * dtype_bytes

    shard_peak = flops_peak / (shards if shared_host_core else 1)
    compute_us = max(local_flops / shard_peak, local_bytes / bw_hbm)
    comm_us = (
        (allreduce_bytes + gather_bytes) / bw_coll
        + n_collectives * coll_overhead_us
    )
    if overlap:
        # Chunked-psum schedule: chunk k+1's all-reduce overlaps chunk k's
        # tail, so the shorter leg hides behind the longer one.  Dispatch
        # stays serial (it gates the first chunk).
        us = max(compute_us, comm_us) + dispatch_us
    else:
        us = compute_us + comm_us + dispatch_us
    return {
        "local_flops": local_flops,
        "local_hbm_bytes": local_bytes,
        "allreduce_bytes": allreduce_bytes,
        "gather_bytes": gather_bytes,
        "n_collectives": n_collectives,
        "peak_bytes_per_shard": peak,
        "compute_us": compute_us,
        "comm_us": comm_us,
        "us": us,
        "comm_fraction": comm_us / us if us > 0 else 0.0,
    }


def mesh_crossover_shards(
    *,
    n_modules: int,
    padded_vec: int,
    cohort: int,
    rpca_iters: int = 30,
    svt_rank: int = 8,
    svt_sweeps: int = 2,
    warm: bool = True,
    max_shards: int = 64,
    **rates,
) -> int | None:
    """Smallest power-of-two shard count predicted to beat one device when
    each shard has a device of its own (per-shard compute scales 1/n;
    ``shared_host_core=False``).  None if communication overhead swamps the
    saving by ``max_shards`` — the regime where the cohort is too small to
    be worth distributing.  ``rates`` go to ``mesh_agg_costs``.
    """
    kw = dict(
        n_modules=n_modules, padded_vec=padded_vec, cohort=cohort,
        rpca_iters=rpca_iters, svt_rank=svt_rank, svt_sweeps=svt_sweeps,
        warm=warm, shared_host_core=False, **rates,
    )
    base = mesh_agg_costs(shards=1, **kw)["us"]
    n = 2
    while n <= max_shards:
        # Ragged cohorts shard fine (they pad); the model already charges
        # for the padded slice via ceil(cohort / n).
        if mesh_agg_costs(shards=n, **kw)["us"] < base:
            return n
        n *= 2
    return None


def uplink_costs(
    *,
    n_modules: int,
    padded_vec: int,
    cohort: int,
    svt_rank: int = 8,
    k: int = 64,
    dense_rounds_frac: float = 0.0,
    dtype_bytes: int = 4,
    idx_bytes: int = 4,
) -> Dict[str, float]:
    """Analytic per-round wire bytes of the sketch uplink.

    A dense client ships its full f32 delta: ``B * d1`` values per module
    set (``padded_vec`` already includes the bucket's zero padding — the
    wire model charges for it, matching the engine's ``bytes_up`` counter,
    which bills the *true* dims; pass the true per-module vec for exact
    agreement).  A sketched client ships, per module, ``r`` basis
    coefficients plus a top-``k`` sparse residual (value + index per
    entry), where ``r`` is the carried basis width — the ``subspace_rank``
    ceil cap over the cohort.

    ``dense_rounds_frac`` blends in the codec's dense fallback rounds
    (cold start / basis-drift gate trips): a fraction f of rounds pay the
    dense wire, so the effective reduction is the harmonic blend, not the
    pure sketch ratio.  The ``breakeven_k`` returned is the largest k at
    which sketch still beats dense (coefficients included), clamped >= 0.

    Downlink: the server multicasts one basis (``B * d1 * r``) per sketch
    round on top of the model broadcast; both are counted once (multicast),
    so the uplink is where the n_clients scaling lives.
    """
    if cohort < 1:
        raise ValueError(f"cohort must be >= 1, got {cohort}")
    b, d1 = float(n_modules), float(padded_vec)
    r = float(max(1, min(svt_rank, (cohort + 1) // 2)) if cohort > 1 else 1)
    kk = float(min(max(int(k), 1), int(padded_vec)))

    dense_per_client = b * d1 * dtype_bytes
    sketch_per_client = b * (r * dtype_bytes + kk * (dtype_bytes + idx_bytes))
    f = min(max(dense_rounds_frac, 0.0), 1.0)
    eff_per_client = f * dense_per_client + (1.0 - f) * sketch_per_client

    basis_down = b * d1 * r * dtype_bytes * (1.0 - f)
    # Largest k where the sketch wire (coef + k * (val+idx)) still beats
    # dense: k < (d1 * dtype - r * dtype) / (dtype + idx).
    breakeven_k = max(
        0.0, (d1 * dtype_bytes - r * dtype_bytes) / (dtype_bytes + idx_bytes)
    )
    return {
        "dense_bytes_per_client": dense_per_client,
        "sketch_bytes_per_client": sketch_per_client,
        "effective_bytes_per_client": eff_per_client,
        "uplink_bytes_round": eff_per_client * cohort,
        "dense_bytes_round": dense_per_client * cohort,
        "basis_downlink_bytes": basis_down,
        "reduction_vs_dense": dense_per_client / max(eff_per_client, 1.0),
        "breakeven_k": breakeven_k,
        "sketch_wins": sketch_per_client < dense_per_client,
    }
