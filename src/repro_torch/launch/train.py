"""Federated LoRA fine-tuning CLI (port of ``repro/launch/train.py``).

Per round: every client takes ``--local-steps`` LoRA steps on its own
Markov-LM shard (``data.client_lm_datasets``), the deltas are aggregated
with ``--aggregator`` (FedRPCA by default), and checkpoints are written
every ``--ckpt-every`` rounds.  The round runs as its two halves
(``steps.make_local_step``, ``steps.make_agg_step``) through
``fed.pipeline.run_rounds``, so every round logs per-phase wall clocks, and
``--pipeline`` overlaps them: round r's local phase runs while up to
``--staleness`` earlier aggregations are still in flight on a worker
thread and CUDA side stream.  ``--staleness 0`` keeps the synchronous
schedule.

``--faults`` injects seeded failures (``nan:0.1``,
``dropout:0.2,straggler:0.5``, ...); the pre-aggregation quarantine
(``fed.guard``) switches on with them (force with ``--guard`` /
``--no-guard``), and the run exits 1 if the final state is non-finite or
a corrupted column ever escaped the screen.  An inert flag combination
exits 2.  ``--uplink sketch[:k[:tol]]`` sends the deltas through the
carry-basis sketch codec (``fed.sketch``); ``--client-ranks 8,4,2``
zero-masks each client's delta beyond its declared rank.

The run is on ``--device`` (default ``cuda``: the LoRA projections, the
attention and the SSD scan run their CUDA kernels forward, with plain
PyTorch backward passes); ``--device cpu`` runs the plain versions.

On the CPU, at the reduced size:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --reduced \\
      --device cpu --rounds 2 --clients 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b --reduced \\
      --device cpu --rounds 2 --clients 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m --reduced \\
      --device cpu --rounds 2 --clients 4
On a card, at full width (any ``--arch`` of ``repro_torch.configs``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --clients 8 --per-client-batch 2 --seq 256 --rounds 3 --svt-mode subspace \\
      --carry-mode subspace --rpca-fused-tail --uplink sketch
"""
from __future__ import annotations

import argparse
import sys
import types
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.checkpoint import checkpoint_metadata, restore_checkpoint, save_checkpoint
from repro_torch.core import CARRY_MODES, ENGINES, METHODS, SVT_MODES, WEIGHTINGS, AggregatorConfig
from repro_torch.core import engine as engine_lib
from repro_torch.data import client_lm_datasets
from repro_torch.fed import faults as faults_lib
from repro_torch.fed import guard as guard_lib
from repro_torch.fed import partition as partition_lib
from repro_torch.fed import sketch as sketch_lib
from repro_torch.fed.pipeline import run_rounds
from repro_torch.kernels import backend
from repro_torch.launch import steps as steps_lib
from repro_torch.models import init_lora_params, init_params, loss_fn
from repro_torch.utils import get_logger
from repro_torch.utils.pytree import tree_leaves, tree_map

log = get_logger("train")


class _CliState(NamedTuple):
    """The CLI's buffer for ``fed.pipeline.run_rounds``: the scheduler
    touches ``lora_global`` / ``agg_carry`` through ``_replace``."""

    lora_global: Any
    agg_carry: Any
    round_idx: int


class _CliBundle(NamedTuple):
    """Local-phase hand-off: ``loss_mean`` feeds the scheduler's timers, the
    rest the aggregation step."""

    deltas: Any
    mask: Any
    round_key: Any
    loss_mean: Any
    fault_slots: Any = None  # injected-corruption marker (fed.faults)


def build_batches(client_tokens: np.ndarray, per_client: int, seq: int,
                  rng: np.random.Generator, device):
    """One round's (M, per_client, S) token / label batch on ``device``."""
    m, n_seqs, _ = client_tokens.shape
    idx = rng.integers(0, n_seqs, size=(m, per_client))
    seqs = np.take_along_axis(client_tokens, idx[:, :, None], axis=1)
    return {
        "tokens": torch.as_tensor(seqs[:, :, :seq], device=device),
        "labels": torch.as_tensor(seqs[:, :, 1:seq + 1], device=device),
    }


def evaluate(model, lora, cfg, test_tokens: np.ndarray, batch: int = 8) -> float:
    """Mean next-token loss of the first ``batch`` test sequences."""
    dev = model.embed.device
    tokens = torch.as_tensor(test_tokens[:batch, :-1], device=dev)
    labels = torch.as_tensor(test_tokens[:batch, 1:], device=dev)
    with torch.no_grad():
        loss, _ = loss_fn(model, lora, {"tokens": tokens, "labels": labels}, cfg)
    return float(loss)


def _finite(tree) -> torch.Tensor:
    return torch.stack([torch.isfinite(x).all() for x in tree_leaves(tree)]).all().to(
        torch.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="mamba2-130m", help="architecture id")
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--per-client-batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--local-lr", type=float, default=1e-3)
    ap.add_argument("--local-optimizer", default="adam", choices=["sgd", "adam"])
    ap.add_argument("--aggregator", default="fedrpca", choices=list(METHODS))
    ap.add_argument("--engine", default="packed", choices=list(ENGINES),
                    help="server aggregation engine (packed = bucketed batched)")
    ap.add_argument("--clients-per-round", type=int, default=0,
                    help="partial participation: sample this many clients per round "
                         "through a validity mask (0 = all)")
    ap.add_argument("--weighting", default="uniform", choices=list(WEIGHTINGS),
                    help="client aggregation weights: uniform mean, data-size-weighted, "
                         "or data_size_rpca (weights column-scale M before the split)")
    ap.add_argument("--rpca-iters", type=int, default=30)
    ap.add_argument("--rpca-fused-tail", action="store_true",
                    help="run the RPCA elementwise tail through the fused kernels "
                         "(admm_tail / subspace_apply; packed engine)")
    ap.add_argument("--mesh-overlap", action="store_true",
                    help="sharded aggregation: chunk the bucket axis so each chunk's "
                         "reduction overlaps the next chunk's compute (no-op without "
                         "--mesh-shards > 1)")
    ap.add_argument("--svt-mode", default="gram", choices=list(SVT_MODES),
                    help="RPCA SVT step: per-iteration eigh (gram) or warm-started "
                         "subspace iteration (subspace)")
    ap.add_argument("--svt-rank", type=int, default=8,
                    help="subspace SVT: carried eigenbasis width cap")
    ap.add_argument("--svt-sweeps", type=int, default=2,
                    help="subspace SVT: power sweeps per ADMM iteration")
    ap.add_argument("--carry-mode", default="none", choices=list(CARRY_MODES),
                    help="cross-round aggregation session carry (packed engine, fedrpca; "
                         "subspace carry needs --svt-mode subspace)")
    ap.add_argument("--uplink", default="dense",
                    help="client->server wire codec: 'dense' or 'sketch[:k[:energy_tol]]' "
                         "(project each delta onto the carried RPCA basis and ship "
                         "coefficients plus a top-k sparse residual, gated back to dense "
                         "on cold or drifted rounds; needs --carry-mode != none)")
    ap.add_argument("--client-ranks", default=None,
                    help="heterogeneous per-client LoRA ranks: a comma list cycled over "
                         "the clients (e.g. '8,4,2'); each client's delta is zero-masked "
                         "beyond its declared rank before aggregation")
    ap.add_argument("--pipeline", action="store_true",
                    help="overlap each round's local phase with earlier rounds' "
                         "aggregations (worker thread, CUDA side stream)")
    ap.add_argument("--staleness", type=int, default=1,
                    help="pipeline depth bound: aggregations that may stay in flight "
                         "(0 = synchronous schedule)")
    ap.add_argument("--faults", default=None,
                    help="seeded fault injection spec (fed.faults.parse), e.g. 'nan:0.1' "
                         "or 'dropout:0.2,straggler:0.5,delay:2.0'")
    ap.add_argument("--guard", dest="guard", action="store_true", default=None,
                    help="force the pre-aggregation quarantine on (default: on exactly "
                         "when --faults is set)")
    ap.add_argument("--no-guard", dest="guard", action="store_false",
                    help="force the pre-aggregation quarantine off")
    ap.add_argument("--mesh-shards", type=int, default=0,
                    help="shard the aggregation's packed client axis over this many "
                         "shards (launch.mesh.make_host_mesh; 0/1 = unsharded). Packed "
                         "engine only: the reference engine runs unsharded with a warning")
    ap.add_argument("--heterogeneity", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    carry_on = (args.carry_mode != "none" and args.engine == "packed"
                and args.aggregator == "fedrpca")
    if args.carry_mode != "none" and not carry_on:
        # A silently inert flag would report cold-start numbers as warm.
        ap.error(
            f"--carry-mode {args.carry_mode} has no effect with --engine {args.engine} / "
            f"--aggregator {args.aggregator}: the cross-round aggregation session exists "
            "only for --engine packed --aggregator fedrpca; drop --carry-mode (or set it "
            "to none)"
        )
    if args.staleness < 0:
        ap.error(f"--staleness must be >= 0, got {args.staleness}")
    uplink_cfg = sketch_lib.parse_uplink(args.uplink)
    if uplink_cfg.active and not carry_on:
        log.warning("--uplink %s needs --carry-mode != none (packed fedrpca) for a basis to "
                    "project onto; running dense", args.uplink)
        uplink_cfg = None
    if args.mesh_shards < 0:
        ap.error(f"--mesh-shards must be >= 0, got {args.mesh_shards}")
    dev = backend.resolve_device(args.device)
    mesh = None
    if args.mesh_shards > 1:
        if args.engine != "packed":
            log.warning("--mesh-shards %d with --engine %s: the reference engine is the "
                        "unsharded parity oracle; running the aggregation unsharded",
                        args.mesh_shards, args.engine)
        else:
            from repro_torch.launch.mesh import make_host_mesh

            mesh = make_host_mesh(args.mesh_shards, device=dev)
            log.info("aggregation client axis sharded over %d shards", args.mesh_shards)
    fault_model = None
    if args.faults:
        fcfg = faults_lib.parse(args.faults, seed=args.seed)
        if fcfg.active:
            fault_model = faults_lib.FaultModel(fcfg)
            log.info("fault injection on: %s", fcfg)
    guard_on = fault_model is not None if args.guard is None else args.guard
    guard_cfg = guard_lib.GuardConfig() if guard_on else None

    cfg = cfglib.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    log.info("arch=%s layers=%d d_model=%d vocab=%d device=%s", cfg.name, cfg.n_layers,
             cfg.d_model, cfg.vocab_size, dev)

    client_tokens, test = client_lm_datasets(
        args.clients, vocab_size=min(cfg.vocab_size, 512), n_seqs=32, seq_len=args.seq,
        heterogeneity=args.heterogeneity, seed=args.seed,
    )
    model = init_params(cfg, seed=args.seed, device=dev)
    lora = init_lora_params(cfg, seed=args.seed + 1, device=dev)

    # Heterogeneous ranks: each client's delta is zero-masked beyond its
    # declared rank before the wire and the aggregation.
    ranks_all = rank_masks = None
    if args.client_ranks:
        lora_rank = partition_lib.infer_lora_rank(lora)
        ranks_all = partition_lib.parse_client_ranks(args.client_ranks, args.clients, lora_rank)
        rank_masks = partition_lib.client_rank_masks(lora, ranks_all, lora_rank)
        log.info("heterogeneous client ranks: %s (template rank %d)", ranks_all.tolist(),
                 lora_rank)

    agg = AggregatorConfig(
        method=args.aggregator, rpca_iters=args.rpca_iters, weighting=args.weighting,
        svt_mode=args.svt_mode, svt_rank=args.svt_rank, svt_sweeps=args.svt_sweeps,
        carry_mode=args.carry_mode, rpca_fused_tail=args.rpca_fused_tail,
        mesh_overlap=args.mesh_overlap,
        guard_energy_k=guard_cfg.energy_k if guard_cfg is not None else 0.0,
    )
    # Cross-round session: the plan and its empty carry are built once from
    # a zero delta tree with the round's client axis.
    carry = agg_plan = None
    if carry_on:
        example = tree_map(lambda x: torch.zeros((args.clients, *x.shape), dtype=x.dtype,
                                                 device=dev), lora)
        agg_plan = engine_lib.plan_aggregation(
            example, agg, mesh=mesh, uplink=uplink_cfg,
            client_ranks=None if ranks_all is None else ranks_all.tolist(),
        )
        carry = engine_lib.init_agg_carry(agg_plan)

    start_round = 0
    if args.resume and args.ckpt_dir:
        meta = checkpoint_metadata(args.ckpt_dir)
        if meta.get("format") == "session":
            if not carry_on:
                raise ValueError(
                    f"checkpoint under {args.ckpt_dir} is an aggregation-session checkpoint "
                    "(it carries AggCarry state), but this run has the carry disabled; rerun "
                    f"with --carry-mode {meta.get('carry_mode', 'subspace')} (packed fedrpca)"
                )
            restored, meta = restore_checkpoint(args.ckpt_dir, {"lora": lora, "agg_carry": carry})
            lora, carry = restored["lora"], restored["agg_carry"]
        else:
            if carry_on:
                log.warning("resuming a carry-mode run from a LoRA-only checkpoint: the "
                            "aggregation session cold-starts")
            lora, meta = restore_checkpoint(args.ckpt_dir, lora)
        start_round = int(meta.get("round", meta.get("step", 0)))
        log.info("resumed from round %s", start_round)

    # Synthetic client shards all hold n_seqs sequences.
    client_sizes = np.full(args.clients, client_tokens.shape[1], np.float64)
    local_step = steps_lib.make_local_step(
        cfg, local_lr=args.local_lr, local_steps=args.local_steps,
        local_optimizer=args.local_optimizer, remat=False,
        clients_per_round=args.clients_per_round,
    )
    agg_step = steps_lib.make_agg_step(
        agg, engine=args.engine, client_weights=client_sizes / client_sizes.sum(), mesh=mesh,
        uplink=uplink_cfg,
    )
    depth = args.staleness if args.pipeline else 0

    # The local phase builds its round's batch from a generator seeded by
    # (seed, round), so a resumed run sees the batches an uninterrupted one
    # would have.
    def cli_local(state: _CliState, n_active=None):
        del n_active
        r = state.round_idx
        batch = build_batches(client_tokens, args.per_client_batch, args.seq,
                              np.random.default_rng((args.seed, 1000 + r)), dev)
        round_key = (args.seed, 1000 + r)
        deltas, loss, mask = local_step(model, state.lora_global, batch, round_key)
        if rank_masks is not None:
            deltas = tree_map(lambda d, mk: d * mk.to(d.dtype), deltas, rank_masks)
        fault_slots = None
        if fault_model is not None:
            if mask is None:
                mask = torch.ones((args.clients,), dtype=torch.float32, device=dev)
            deltas, mask, fault_slots = fault_model.inject(r, deltas, mask)
        bundle = _CliBundle(deltas=deltas, mask=mask, round_key=round_key, loss_mean=loss,
                            fault_slots=fault_slots)
        return state._replace(round_idx=r + 1), bundle

    def screen(bundle: _CliBundle):
        deltas, mask2 = bundle.deltas, bundle.mask
        sflags, sdiags = None, {}
        if guard_cfg is not None:
            if mask2 is None:
                mask2 = torch.ones((args.clients,), dtype=torch.float32, device=dev)
            deltas, mask2, g = guard_lib.screen(deltas, mask2, guard_cfg)
            sflags = g.pop("flags")
            sdiags = g
        return deltas, mask2, sflags, sdiags

    def fault_diags(upd, sflags, bundle: _CliBundle, sdiags):
        diags = dict(sdiags)
        diags["update_finite"] = _finite(upd)
        if bundle.fault_slots is not None:
            diags["fault_injected"] = torch.sum(bundle.fault_slots)
            if sflags is not None:
                diags["fault_caught"] = torch.sum(sflags * bundle.fault_slots)
        return diags

    # Wire accounting: a dense f32 delta costs 4 bytes a parameter for each
    # live client; the sketch codec reports its exact ``bytes_up`` and
    # ``bytes_down_basis``.  ``bytes_down`` is the update broadcast (once:
    # multicast) plus, on sketch rounds, the basis.
    per_client_bytes = 4.0 * sum(x.numel() for x in tree_leaves(lora))

    def wire_metrics(metrics, mask2):
        m = dict(metrics)
        n_eff = float(args.clients) if mask2 is None else torch.sum(mask2)
        if "bytes_up" not in m:
            m["bytes_up"] = per_client_bytes * n_eff
        m["bytes_down"] = per_client_bytes + m.pop("bytes_down_basis", 0.0)
        return m

    def cli_agg(agg_carry, bundle: _CliBundle, scale):
        deltas, mask2, sflags, sdiags = screen(bundle)
        if carry_on:
            upd, metrics, new_carry = agg_step(deltas, mask2, bundle.round_key, agg_carry, scale)
        else:
            upd, metrics = agg_step(deltas, mask2, bundle.round_key, scale=scale)
            new_carry = agg_carry
        metrics = wire_metrics(metrics, mask2)
        return upd, new_carry, {**metrics, **fault_diags(upd, sflags, bundle, sdiags)}

    def cli_cold_carry():
        return engine_lib.init_agg_carry(agg_plan) if agg_plan is not None else None

    # The land-time supervisor's last rung: plain masked FedAvg over the
    # screened deltas, carry-free.
    fallback_step = steps_lib.make_agg_step(
        agg.replace(method="fedavg", carry_mode="none", guard_energy_k=0.0),
        engine=args.engine, client_weights=client_sizes / client_sizes.sum(), mesh=mesh,
    )

    def cli_fallback(bundle: _CliBundle, scale):
        deltas, mask2, sflags, sdiags = screen(bundle)
        upd, _ = fallback_step(deltas, mask2, bundle.round_key, scale=scale)
        diags = {**wire_metrics({}, mask2), **fault_diags(upd, sflags, bundle, sdiags),
                 "degraded": 1.0}
        return upd, cli_cold_carry(), diags

    phases = types.SimpleNamespace(
        local=cli_local, agg=cli_agg, prep_state=lambda s: s, apply=steps_lib.apply_update,
        fallback=cli_fallback, cold_carry=cli_cold_carry,
    )

    fault_totals = {"injected": 0.0, "caught": 0.0, "escapes": 0.0, "degraded": 0.0,
                    "retries": 0.0}
    history = []

    def on_round(r, state: _CliState, diags):
        rg = start_round + r  # global round index (resume offset)
        diags = {k: float(v) for k, v in diags.items()}
        history.append({"round": rg, **diags})
        fault_totals["injected"] += diags.get("fault_injected", 0.0)
        fault_totals["caught"] += diags.get("fault_caught", 0.0)
        if diags.get("screen_clean", 1.0) == 0.0:
            fault_totals["escapes"] += 1.0
        fault_totals["degraded"] += diags.get("degraded", 0.0)
        fault_totals["retries"] += diags.get("supervisor_retry", 0.0)
        extra = "".join(f"  {k}={v:.3g}" for k, v in diags.items()
                        if k != "mean_local_loss" and not k.startswith("t_"))
        log.info("round %03d  local_loss=%.4f%s  t_local=%.2fs t_agg=%.2fs t_overlap=%.2fs",
                 rg, diags["mean_local_loss"], extra, diags.get("t_local_s", 0.0),
                 diags.get("t_agg_s", 0.0), diags.get("t_overlap_s", 0.0))
        if args.ckpt_dir and (rg + 1) % args.ckpt_every == 0:
            if carry_on:
                save_checkpoint(
                    {"lora": state.lora_global, "agg_carry": state.agg_carry}, args.ckpt_dir,
                    rg + 1, metadata={"arch": cfg.name, "round": rg + 1, "format": "session",
                                      "carry_mode": args.carry_mode},
                )
            else:
                save_checkpoint(state.lora_global, args.ckpt_dir, rg + 1,
                                metadata={"arch": cfg.name, "round": rg + 1})

    initial = evaluate(model, lora, cfg, test.tokens)
    log.info("initial eval loss %.4f", initial)
    if depth:
        log.info("pipeline on: staleness bound %d", depth)
    state = run_rounds(phases, _CliState(lora, carry, start_round),
                       max(args.rounds - start_round, 0), staleness=depth, on_round=on_round)
    lora = state.lora_global
    if fault_model is not None or guard_cfg is not None:
        inj, caught = fault_totals["injected"], fault_totals["caught"]
        log.info("fault summary: injected=%d caught=%d (%.0f%%) screen_escapes=%d "
                 "supervisor_retries=%d degraded_rounds=%d", int(inj), int(caught),
                 100.0 * caught / max(inj, 1.0), int(fault_totals["escapes"]),
                 int(fault_totals["retries"]), int(fault_totals["degraded"]))
        if fault_totals["escapes"]:
            log.error("quarantine escape: a screened round was not finite")
            sys.exit(1)
    if not bool(_finite(lora)):
        log.error("final global LoRA state is non-finite")
        sys.exit(1)
    final = evaluate(model, lora, cfg, test.tokens)
    log.info("final eval loss %.4f", final)
    peak = None
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        log.info("peak device memory %.3f GiB", peak)
    return {"initial_eval_loss": initial, "final_eval_loss": final, "rounds": history,
            "lora": lora, "agg_carry": state.agg_carry, "peak_gib": peak}


if __name__ == "__main__":
    main()
