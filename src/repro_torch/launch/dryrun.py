"""One-card dry run of every (arch x shape) (port of ``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun [--arch ID] [--shape NAME]
        [--mesh card|single|multi|all] [--device cuda|cpu] [--kv-quant] ...

Each (arch, shape) gives one JSON record (written to ``--out``, one line
printed), with the reference's keys where they have a counterpart: the
analytic per-chip cost model (``launch/costmodel.py``) and its roofline
terms at the card's rates, the parameter counts of the meta-built model,
MODEL_FLOPS and the useful-FLOPs ratio.  Parameters are built on the
``meta`` device, which allocates and draws nothing, so every config counts
in seconds on the CPU (Llama-4-Maverick's 777 B parameters included).

``--mesh card`` (the default): one card, a model axis of 1 and one client
shard.  The bytes of the step's arguments and outputs and of its largest
layer's activations (``reckon_activation_bytes``) are reckoned from the
shapes; where they fit in 90% of the device's memory the case is built and
run there (weights drawn on the device, zero caches, decode at
``cache_index = seq_len - 1``): once to warm up, then once timed to a
synchronize.  The record then holds ``step_s``, the peak bytes the case
allocated and ``mfu = model_flops / (step_s * roofline.PEAK_FLOPS)`` (on a card).
Otherwise the case is ``skipped`` with the reckoned GiB as its reason.  A
case that was admitted and then fails, out-of-memory included, is an
``error``, and the CLI exits 1 on any error.  Without CUDA the run raises
unless ``--device cpu`` is given.

``--mesh single`` / ``multi``: analytic records for the reference's
production meshes ((16, 16) and (2, 16, 16) chips, ``launch/mesh.py``): the
cost model and roofline at a model axis of 16 and 16 or 32 client shards,
and the bytes one chip holds of the step's arguments under the sharding
rules (``models/partitioning.py``).  Nothing runs; the status is
``analytic``.

The reference's keys that only a compiled XLA program gives (``hlo_flops``,
``hlo_bytes``, ``collectives``, ``roofline_static_hlo``, ``lower_s``,
``compile_s``) have no counterpart in eager PyTorch, nor has
``--save-hlo``.  ``--attn-schedule`` reaches the cost model only: the
attention kernel always skips the blocks above the diagonal.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback

import torch

from repro_torch import configs as cfglib
from repro_torch.config import MeshConfig
from repro_torch.core import AggregatorConfig
from repro_torch.kernels import backend
from repro_torch.launch import costmodel as cm
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import client_axes, make_production_mesh
from repro_torch.models import init_decode_caches, init_lora_params, init_params
from repro_torch.models import partitioning as part
from repro_torch.models.moe import _capacity
from repro_torch.models.ssd import ssd_dims
from repro_torch.utils.pytree import tree_leaves, tree_map

MESHES = ("card", "single", "multi")
MESH_NAMES = {"card": "card", "single": "16x16", "multi": "2x16x16"}
#: Share of the device's memory a case may reckon to use.
BUDGET_SHARE = 0.9
_GIB = 2.0**30


def abstract_params(cfg):
    """(base model, LoRA tree) on ``meta``: shapes and dtypes, no storage."""
    return init_params(cfg, device="meta"), init_lora_params(cfg, device="meta")


def _nbytes(tree) -> int:
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def reckon_activation_bytes(cfg, shape, *, n_clients: int = 1) -> int:
    """Bytes of the largest layer's activations in one step of ``shape``,
    reckoned from the shapes as the sum of every intermediate the layer's
    forward allocates (none counted as freed), plus the embeddings and the
    logits; a training step adds each layer's saved input (the blocks are
    recomputed) and twice the largest layer for its backward.

    Per token of the T in flight (B at decode, B S otherwise): each norm's
    float32 upcast, square and product and the cast back; attention's q, k
    and v, two float32 rotary temporaries, the contiguous head-major copies
    the kernel reads, its output and the o projection; the FFN's gate, up,
    activation and product (GELU: three); the SSD mixer's in_proj, the conv
    window's sums and the float32 x, x dt, y and gate; the RG-LRU's two
    projections, conv, gates and four float32 scan buffers.  Per call:
    decode attention's float32 scores (three of them) and cast
    probabilities over the cache, and K and V re-laid or, from an int8
    cache, dequantized (the float32 upcast, its product with the scales and
    the cast); the MoE's routing (int64 one-hot and its running counts) and the
    expert buffers at capacity; cross-attention's materialized scores; the
    SSD kernel's scratch, and at decode its state's three temporaries.
    """
    ab = 4 if cfg.dtype == "float32" else 2
    b, s = shape.global_batch, shape.seq_len
    decode, train = shape.kind == "decode", shape.kind == "train"
    t = b * (1 if decode else s)
    d = cfg.d_model
    h = cfg.n_heads
    norm = 12 * d + ab * d

    def attention(kind, tokens, q_len):
        qkv = cfg.q_dim + 2 * cfg.kv_dim
        per = norm + qkv * ab + 2 * (cfg.q_dim + cfg.kv_dim) * 4 + 3 * cfg.q_dim * ab
        per += cfg.q_dim * ab + d * ab
        total = tokens * per
        window = cfg.window_size if kind == "local_attn" else 0
        if decode:
            ctx = min(window, s) if window else s
            total += b * h * ctx * (3 * 4 + ab)
            total += 2 * b * ctx * cfg.kv_dim * ((4 + 4 + ab) if cfg.kv_quant else ab)
        elif train:  # the plain backward materializes the scores
            total += (tokens // q_len) * h * q_len * min(window or q_len, q_len) * 4 * 3
        return total

    def cross():
        per = norm + 2 * cfg.q_dim * ab + d * ab
        total = t * per + b * h * (1 if decode else s) * cfg.encoder_seq * (3 * 4 + ab)
        if not decode:
            total += b * cfg.encoder_seq * 2 * cfg.kv_dim * ab
        return total

    def ffn(tokens):
        if cfg.d_ff == 0:
            return 0
        if cfg.n_experts:
            groups = n_clients if train else 1
            e, k = cfg.n_experts, max(cfg.top_k, 1)
            cap = _capacity(tokens // groups, k, e, cfg.capacity_factor)
            entries = tokens * k
            return (tokens * (norm + 3 * e * 4 + d * ab) + entries * e * 8 * 2
                    + entries * d * ab * 2 + groups * e * cap * (2 * d + 3 * cfg.d_ff) * ab)
        mats = 4 if cfg.ffn_kind in ("swiglu", "geglu") else 3
        return tokens * (norm + mats * cfg.d_ff * ab + d * ab)

    def mixer(kind):
        if kind in ("attn", "local_attn"):
            return attention(kind, t, 1 if decode else s)
        if kind == "ssd":
            sd = ssd_dims(cfg)
            n, heads, p = cfg.ssm_state, sd["n_heads"], cfg.ssm_head_dim
            proj = 2 * sd["d_inner"] + 2 * n + heads
            per = (norm + proj * ab + sd["conv_dim"] * ab * (cfg.conv_width + 2)
                   + sd["d_inner"] * 4 * 5 + 2 * n * 4 + heads * 4 * 3
                   + sd["d_inner"] * (4 * 3 + ab) + d * ab)
            total = t * per
            if decode:
                total += 3 * b * heads * p * n * 4
            else:  # the kernel's score tiles and sums of da
                tiles = -(-s // 64)
                total += tiles * 64 * (b * 64 + b * heads) * 4
                if train:  # the plain backward's chunked form
                    total += b * heads * s * cfg.ssm_chunk * 4 * 4
            return total
        w = cfg.lru_width or d
        per = (norm + 2 * w * ab + w * ab * (cfg.conv_width + 2) + 2 * w * ab + 8 * w * 4
               + w * ab + d * ab)
        return t * per + (0 if decode else 4 * t * w * 4)

    block = max(mixer(k) for k in set(cfg.layer_pattern))
    block += ffn(t) + 2 * t * d * ab
    if cfg.encoder_decoder:
        block += cross()
    total = 2 * t * d * ab + block
    head_tokens = t if train else b
    total += head_tokens * cfg.vocab_size * (ab + 4 * (3 if train else 2))
    if cfg.encoder_decoder and not decode:
        t_enc = b * cfg.encoder_seq
        enc_block = attention("attn", t_enc, cfg.encoder_seq) + ffn(t_enc)
        total += t_enc * d * ab * 2 + enc_block
    if train:
        total += cfg.n_layers * t * d * ab + 2 * block
    return int(total)


def _step_io_bytes(cfg, shape, base, lora, specs, caches):
    """(argument bytes, output bytes) of one step on one device."""
    args = _nbytes(base) + _nbytes(lora) + _nbytes(specs)
    logits = shape.global_batch * cfg.vocab_size * 4
    if shape.kind == "train":
        return args, _nbytes(lora)
    if shape.kind == "prefill":  # each layer's caches, then their stacked copy
        return args, logits + 2 * _nbytes(caches)
    return args + _nbytes(caches), logits


def _budget(dev: torch.device) -> float:
    """90% of the device's memory (the host's for the CPU), less what the
    process already holds on a card."""
    if dev.type == "cuda":
        return (BUDGET_SHARE * torch.cuda.get_device_properties(dev).total_memory
                - torch.cuda.memory_allocated(dev))
    return BUDGET_SHARE * os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _draw_inputs(specs: dict, cfg, dev, gen) -> dict:
    """Real tensors of the specs' shapes on ``dev``: token ids below the
    vocabulary, stub embeddings N(0, 1)."""
    out = {}
    for k, spec in specs.items():
        if spec.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, spec.shape, generator=gen, device=dev,
                                   dtype=torch.int32)
        else:
            out[k] = torch.randn(spec.shape, generator=gen, device=dev).to(spec.dtype)
    return out


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(x.float()).all()) for x in tree_leaves(tree)
               if x.is_floating_point())


def _run_on_device(cfg, shape, dev, *, aggregator, rpca_iters, local_steps, local_optimizer,
                   microbatch) -> dict:
    """Build the case on ``dev`` (weights, adapter and inputs drawn from
    seeds 0, 1 and 2) and run its step twice; the second is timed.  Returns
    the record's measured fields; the peak counts the bytes allocated above
    what the process held before the case."""
    cuda = dev.type == "cuda"
    held = 0
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    model = init_params(cfg, seed=0, device=dev)
    lora = init_lora_params(cfg, seed=1, device=dev)
    specs = cfglib.input_specs(cfg, shape)
    if shape.kind == "train":
        step = steps_lib.make_fed_train_step(
            cfg, AggregatorConfig(method=aggregator, rpca_iters=rpca_iters),
            local_steps=local_steps, local_optimizer=local_optimizer, microbatch=microbatch)
        batch = _draw_inputs(specs, cfg, dev, gen)
        run = lambda: step(model, lora, batch)
        check = lambda out: _finite(out[0]) and bool(torch.isfinite(out[1]["loss"]))
    elif shape.kind == "prefill":
        step = steps_lib.make_prefill_step(cfg)
        batch = _draw_inputs(specs, cfg, dev, gen)
        run = lambda: step(model, lora, batch)
        check = lambda out: _finite(out[0])
    else:
        step = steps_lib.make_serve_step(cfg)
        caches = init_decode_caches(cfg, shape.global_batch, shape.seq_len, device=dev)
        tokens = _draw_inputs(specs, cfg, dev, gen)["tokens"]
        run = lambda: step(model, lora, tokens, caches, shape.seq_len - 1)
        check = lambda out: (_finite(out[0])
                             and tuple(out[0].shape) == (shape.global_batch, 1, cfg.vocab_size))
    run()
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = run()
    if cuda:
        torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t0
    if not check(out):
        raise FloatingPointError("the step's output is not finite or not of the expected shape")
    return {"step_s": step_s,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) - held if cuda else None}


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run_case(arch: str, shape_name: str, mesh: str = "card", *, aggregator: str = "fedrpca",
             rpca_iters: int = 30, local_steps: int = 1, local_optimizer: str = "sgd",
             arch_cfg=None, shape_cfg=None, tag: str = "", policy: str = "tp",
             microbatch: int = 1, kv_quant: bool = False, attn_schedule: str = "causal_half",
             device="cuda") -> dict:
    """One record of the dry run.  ``arch_cfg`` and ``shape_cfg`` replace the
    registry's config and ``SHAPES[shape_name]`` (a reduced config, a cut
    shape)."""
    if mesh not in MESHES:
        raise ValueError(f"unknown mesh {mesh!r}; expected one of {MESHES}")
    shape = shape_cfg if shape_cfg is not None else cfglib.SHAPES[shape_name]
    cfg0 = arch_cfg if arch_cfg is not None else cfglib.get_config(arch)
    train = shape.kind == "train"
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": MESH_NAMES[mesh],
        "aggregator": aggregator if train else None,
        "policy": policy,
        "microbatch": microbatch,
        "tag": tag,
    }
    if not cfglib.shape_supported(cfg0, shape):
        record.update(status="skipped", reason="unsupported shape (bounded decoder context)")
        return record
    cfg = cfglib.config_for_shape(cfg0, shape)
    if kv_quant:
        cfg = cfg.replace(kv_quant=True)
        record["kv_quant"] = True
    record["attn_schedule"] = attn_schedule
    record["variant"] = "sliding_window" if cfg.layer_pattern != cfg0.layer_pattern else "native"
    dev = backend.resolve_device(device) if mesh == "card" else None
    try:
        if mesh == "card":
            model_size, n_cl, chips = 1, 1, 1
        else:
            pmesh = make_production_mesh(multi_pod=mesh == "multi")
            model_size = dict(zip(pmesh.axes, pmesh.shape))["model"]
            n_cl, chips = pmesh.n_clients, pmesh.n_devices
        costs = cm.step_costs(
            cfg, shape, model_size=model_size, client_shards=n_cl, local_steps=local_steps,
            rpca_iters=rpca_iters, aggregator=aggregator if train else "none", policy=policy,
            attn_schedule=attn_schedule,
        )
        record["analytic"] = {
            "flops_per_chip": costs.total_flops,
            "hbm_bytes_per_chip": costs.total_hbm_bytes,
            "collective_bytes_per_chip": costs.total_collective_bytes,
            "flops_breakdown": costs.flops,
            "hbm_breakdown": costs.hbm_bytes,
            "collective_breakdown": costs.collective_bytes,
        }
        record["roofline"] = rl.roofline_terms(
            costs.total_flops, costs.total_hbm_bytes, costs.total_collective_bytes, chips)
        base, lora = abstract_params(cfg)
        n_params = rl.count_params(base) + rl.count_params(lora)
        n_active = rl.count_active_params(base, cfg) + rl.count_params(lora)
        mf = rl.model_flops(cfg, shape, n_active)
        record.update(
            n_params=int(n_params), n_active_params=int(n_active), model_flops=mf,
            useful_flops_ratio=mf / (costs.total_flops * chips) if costs.total_flops else None,
        )
        specs = cfglib.input_specs(cfg, shape, n_clients=n_cl)
        caches = None
        if shape.kind != "train":
            caches = init_decode_caches(cfg, shape.global_batch, shape.seq_len, device="meta")
        if mesh == "card":
            _card_case(record, cfg, shape, base, lora, specs, caches, dev,
                       aggregator=aggregator, rpca_iters=rpca_iters, local_steps=local_steps,
                       local_optimizer=local_optimizer, microbatch=microbatch)
        else:
            record["memory"] = {"argument_size_in_bytes": _sharded_argument_bytes(
                cfg, shape, pmesh, base, lora, specs, caches, policy=policy)}
            record["status"] = "analytic"
    except Exception as e:
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      trace=traceback.format_exc()[-4000:])
    finally:
        if dev is not None:
            _free(dev)
    return record


def _card_case(record, cfg, shape, base, lora, specs, caches, dev, **step_kw) -> None:
    args, outs = _step_io_bytes(cfg, shape, base, lora, specs, caches)
    temp = reckon_activation_bytes(cfg, shape)
    reckoned = args + outs + temp
    budget = _budget(dev)
    record["memory"] = {"argument_size_in_bytes": args, "output_size_in_bytes": outs,
                        "temp_size_in_bytes": temp, "reckoned_bytes": reckoned,
                        "budget_bytes": int(budget)}
    if reckoned > budget:
        record.update(status="skipped",
                      reason=f"reckoned {reckoned / _GIB:.1f} GiB > {budget / _GIB:.1f} GiB "
                             f"({BUDGET_SHARE:.0%} of the device)")
        return
    measured = _run_on_device(cfg, shape, dev, **step_kw)
    record["memory"]["peak_bytes"] = measured["peak_bytes"]
    record.update(status="ok", step_s=measured["step_s"],
                  mfu=(record["model_flops"] / (measured["step_s"] * rl.PEAK_FLOPS)
                       if dev.type == "cuda" else None))


def _sharded_argument_bytes(cfg, shape, pmesh: MeshConfig, base, lora, specs, caches, *,
                            policy: str) -> int:
    """Bytes one chip of the production mesh holds of the step's
    arguments: the base weights under ``policy``, the replicated adapter,
    and the batch (or the decode token and caches) under the batch rules."""
    caxes = client_axes(pmesh)
    model_size = dict(zip(pmesh.axes, pmesh.shape))["model"]
    n_cl = pmesh.n_clients
    total = part.per_device_bytes(base, part.param_pspecs(
        base, cfg, model_size=model_size, policy=policy, fsdp_axes=caxes, fsdp_size=n_cl),
        pmesh)
    total += part.per_device_bytes(lora, part.lora_pspecs(lora), pmesh)
    if shape.kind == "train":
        bspecs = part.batch_pspecs(specs, caxes)
        if policy == "dp" and specs["tokens"].shape[1] % model_size == 0:
            # Weights replicated: the model axis shards the per-client batch.
            bspecs = tree_map(lambda leaf: (caxes, "model", *([None] * (leaf.ndim - 2))),
                              specs)
        return total + part.per_device_bytes(specs, bspecs, pmesh)
    if shape.kind == "prefill":
        return total + part.per_device_bytes(specs, part.batch_pspecs(specs, caxes), pmesh)
    cspecs = part.cache_pspecs(caches, cfg, caxes, model_size=model_size, client_size=n_cl)
    tok = specs["tokens"]
    tspec = (caxes, None) if shape.global_batch % n_cl == 0 else (None, None)
    return (total + part.per_device_bytes(caches, cspecs, pmesh)
            + part.per_device_bytes(tok, tspec, pmesh))


def _fname(record: dict, suffix: str) -> str:
    tag = f"_{record['tag']}" if record.get("tag") else ""
    quant = "_kvq" if record.get("kv_quant") else ""
    return f"{record['arch']}_{record['shape']}_{record['mesh']}{quant}{tag}.{suffix}".replace(
        "/", "-")


def save_record(record: dict, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, _fname(record, "json"))
    with open(path, "w") as f:
        json.dump(record, f, indent=2, default=str)
    return path


def summary(rec: dict) -> str:
    """The one line the CLI prints for a record."""
    status = rec["status"]
    line = f"[{status:8s}] {rec['arch']} x {rec['shape']} x {rec['mesh']}"
    if rec.get("kv_quant"):
        line += " (kv int8)"
    mem = rec.get("memory", {})
    if status == "ok":
        r = rec["roofline"]
        peak = mem.get("peak_bytes")
        line += (f" step={rec['step_s']:.4g}s mfu={rec['mfu']} dom={r['dominant']} "
                 f"reckoned={mem['reckoned_bytes'] / _GIB:.2f}GiB"
                 + ("" if peak is None else f" peak={peak / _GIB:.2f}GiB"))
    elif status == "analytic":
        r = rec["roofline"]
        line += (f" dom={r['dominant']} comp={r['compute_s']:.3e}s mem={r['memory_s']:.3e}s "
                 f"coll={r['collective_s']:.3e}s "
                 f"args/chip={mem['argument_size_in_bytes'] / _GIB:.2f}GiB")
    elif status == "skipped":
        line += " " + rec["reason"]
    else:
        line += " " + rec["error"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=[*cfglib.SHAPES, None],
                    help="input shape (default: all)")
    ap.add_argument("--mesh", default="card", choices=[*MESHES, "all"])
    ap.add_argument("--device", default="cuda", help="device of the card runs (cuda or cpu)")
    ap.add_argument("--aggregator", default="fedrpca",
                    choices=["fedavg", "task_arithmetic", "ties", "fedrpca"])
    ap.add_argument("--rpca-iters", type=int, default=30)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--local-optimizer", default="sgd", choices=["sgd", "adam"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--kv-quant", action="store_true", help="int8 KV cache for decode shapes")
    ap.add_argument("--attn-schedule", default="causal_half",
                    choices=["causal_half", "full_blocks"],
                    help="attention schedule of the cost model")
    ap.add_argument("--policy", default="tp", choices=list(part.POLICIES))
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(cfglib.ARCH_IDS)
    shapes = [args.shape] if args.shape else list(cfglib.SHAPES)
    meshes = list(MESHES) if args.mesh == "all" else [args.mesh]
    if "card" in meshes:
        backend.resolve_device(args.device)  # no CUDA and no --device cpu: raise now

    any_fail = False
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                rec = run_case(
                    arch, shape, mesh, aggregator=args.aggregator, rpca_iters=args.rpca_iters,
                    local_steps=args.local_steps, local_optimizer=args.local_optimizer,
                    tag=args.tag, policy=args.policy, microbatch=args.microbatch,
                    kv_quant=args.kv_quant, attn_schedule=args.attn_schedule,
                    device=args.device,
                )
                save_record(rec, args.out)
                any_fail |= rec["status"] == "error"
                print(summary(rec), flush=True)
    return 1 if any_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
