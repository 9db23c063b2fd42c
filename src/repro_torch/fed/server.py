"""Server round loop: broadcast -> batched local runs -> aggregate -> update.

Port of ``repro/fed/server.py`` for full participation.  The reference
splits a round into jitted local and aggregation phases and drives them
through ``pipeline.run_rounds``; at staleness 0 that is the same schedule as
a plain loop over the rounds, which is what this module runs.

Minibatch indices come from an index stream: by default a CPU
``torch.Generator`` seeded with ``cfg.seed`` (so the same seed draws the
same batches on every device), or the ``batch_indices`` callable a caller
injects.  ``mesh_shards > 1`` shards every aggregation's client axis over
``launch.mesh.make_host_mesh(mesh_shards)`` on the run's device (the
reference engine warns and runs unsharded).  ``carry_mode != "none"`` (packed
engine, fedrpca) makes the rounds one aggregation session: the plan is built
once from ``lora_template`` and the carry rides on ``RoundState.agg_carry``.
DARE's key for round t is ``(cfg.seed, t)``.  Each of these raises until its
later ROADMAP.md item: ``clients_per_round`` below the client count,
``pipeline=True``, ``faults``, a ``guard`` config, a non-dense ``uplink`` and
``client_ranks``.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import engine as engine_lib
from repro_torch.core.aggregators import (
    CARRY_MODES,
    WEIGHTINGS,
    AggregatorConfig,
    aggregate,
    rpca_diag_summary,
)
from repro_torch.fed.client import LocalSpec, make_local_fn
from repro_torch.kernels import backend
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_to, tree_zeros_like

Tree = Any

#: Client samplers of the reference (partial participation is not ported yet).
SAMPLERS = ("uniform", "trace", "size_weighted")


class RoundState(NamedTuple):
    lora_global: Tree
    scaffold_c: Tree
    scaffold_ci: Tree  # (M, ...) per-client variates
    prev_local: Tree  # (M, ...) previous-round local models
    rng: torch.Generator  # CPU generator of the default index stream
    round_idx: int = 0
    agg_carry: Any = ()


@dataclasses.dataclass(frozen=True)
class FedRunConfig:
    """Field for field the reference's run configuration."""

    aggregator: AggregatorConfig
    local: LocalSpec
    rounds: int
    seed: int = 0
    clients_per_round: int = 0  # 0 = full participation (the paper's setting)
    engine: str = "packed"  # "packed" | "reference"
    sampler: str = "uniform"
    pipeline: bool = False
    staleness: int = 1
    faults: Any = None
    guard: Any = None
    mesh_shards: int = 0
    uplink: Any = "dense"
    client_ranks: Any = None


def init_round_state(lora_init: Tree, n_clients: int, seed: int) -> RoundState:
    stacked = tree_map(lambda x: x.unsqueeze(0).expand(n_clients, *x.shape).clone(), lora_init)
    return RoundState(
        lora_global=lora_init,
        scaffold_c=tree_zeros_like(lora_init),
        scaffold_ci=tree_zeros_like(stacked),
        prev_local=stacked,
        rng=torch.Generator().manual_seed(seed),
        round_idx=0,
    )


def _check_config(cfg: FedRunConfig, n_clients: int) -> None:
    """Refuse what this slice does not run yet, naming its ROADMAP.md item."""
    sample_size = cfg.clients_per_round or n_clients
    if not 0 < sample_size <= n_clients:
        raise ValueError(
            f"clients_per_round={cfg.clients_per_round} out of range for {n_clients} clients"
        )
    if cfg.aggregator.weighting not in WEIGHTINGS:
        raise ValueError(
            f"unknown weighting: {cfg.aggregator.weighting!r} (expected one of {WEIGHTINGS})"
        )
    if cfg.sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler: {cfg.sampler!r} (expected one of {SAMPLERS})")
    if cfg.aggregator.carry_mode not in CARRY_MODES:
        raise ValueError(
            f"unknown carry_mode: {cfg.aggregator.carry_mode!r} (expected one of {CARRY_MODES})"
        )
    todo = [
        (sample_size < n_clients, "partial participation (clients_per_round)", "queue 1, item 2"),
        (cfg.pipeline, "the async round pipeline", "queue 1, item 5"),
        (cfg.faults is not None, "fault injection", "queue 1, item 5"),
        (cfg.guard not in (None, False), "the update quarantine (guard)", "queue 1, item 5"),
        (cfg.uplink not in (None, "dense"), "compressed uplinks", "queue 1, item 6"),
        (cfg.client_ranks is not None, "heterogeneous client ranks", "queue 1, item 6"),
    ]
    for bad, what, item in todo:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def _default_indices(state: RoundState, n_clients: int, n_local: int, spec: LocalSpec):
    return torch.randint(
        0, n_local, (n_clients, spec.local_steps, spec.batch_size), generator=state.rng,
    )


def make_round_fn(
    base: Tree, data_x, data_y, cfg: FedRunConfig, client_weights=None,
    batch_indices: Optional[Callable[[int], Any]] = None, lora_template: Tree | None = None,
) -> Callable:
    """Returns fn: (RoundState, n_active=None) -> (RoundState, diagnostics).

    One synchronous round on the device of ``data_x``: every client runs
    ``cfg.local`` from the global LoRA, the stacked deltas are aggregated by
    ``cfg.aggregator`` (``cfg.engine``), and the update is added to the
    global model.  The diagnostics carry host-clock timers ``t_local_s``,
    ``t_agg_s``, ``t_overlap_s`` (always 0: no pipeline) and ``t_round_s``,
    each ending in a device synchronize on CUDA.

    ``batch_indices(round_idx)`` returns the round's (n_clients,
    local_steps, batch_size) minibatch indices; None draws them from the
    state's generator.  ``client_weights`` feed the aggregation
    under ``weighting="data_size"`` / ``"data_size_rpca"``.  With
    ``cfg.mesh_shards > 1`` every aggregation runs on a mesh of that many
    client shards on ``data_x``'s device.

    ``carry_mode != "none"`` with the packed engine and fedrpca needs
    ``lora_template`` (one client's LoRA tree, e.g. the ``lora_init`` of
    ``init_round_state``) to plan the session once; the per-bucket carry
    then rides on ``RoundState.agg_carry`` and the diagnostics gain
    ``fallback_count``, ``live_rank_mean`` and ``carry_hit_rate``.  The
    reference engine ignores ``carry_mode``.
    """
    n_clients, n_local = data_x.shape[0], data_x.shape[1]
    _check_config(cfg, n_clients)
    mesh = None
    if cfg.mesh_shards > 1:
        if cfg.engine != "packed":
            warnings.warn(
                f"mesh_shards={cfg.mesh_shards} with engine={cfg.engine!r}: the "
                "reference engine is the single-device parity oracle; running "
                "the aggregation replicated",
                stacklevel=2,
            )
        else:
            mesh = make_host_mesh(cfg.mesh_shards, device=data_x.device)
    local_fn = make_local_fn(cfg.local)
    dev = data_x.device
    agg_cfg = cfg.aggregator
    use_weights = agg_cfg.weighting in ("data_size", "data_size_rpca")
    w_all = None
    if use_weights:
        if client_weights is None:
            raise ValueError(
                f"weighting={agg_cfg.weighting!r} requires client_weights (e.g. "
                "fed.partition.data_size_weights); refusing to silently fall back "
                "to uniform"
            )
        w_all = torch.as_tensor(np.asarray(client_weights), dtype=torch.float32, device=dev)

    # Cross-round carry: packed-engine fedrpca only (the reference engine is
    # the stateless parity oracle).
    plan = None
    if (agg_cfg.carry_mode != "none" and cfg.engine == "packed"
            and agg_cfg.method == "fedrpca"):
        if lora_template is None:
            raise ValueError(
                f"carry_mode={agg_cfg.carry_mode!r} needs the LoRA structure to plan the "
                "session: pass lora_template= (e.g. the lora_init given to init_round_state)"
            )
        example = tree_map(
            lambda x: torch.zeros((n_clients, *x.shape), dtype=x.dtype, device=dev),
            lora_template,
        )
        plan = engine_lib.plan_aggregation(example, agg_cfg, mesh=mesh)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def round_fn(state: RoundState, n_active=None):
        if n_active is not None:
            raise ValueError(
                f"n_active={n_active} passed to a full-participation round "
                "(set clients_per_round to enable partial participation)"
            )
        if batch_indices is None:
            idx = _default_indices(state, n_clients, n_local, cfg.local)
        else:
            idx = torch.as_tensor(np.asarray(batch_indices(state.round_idx)), dtype=torch.int64)
        t0 = time.perf_counter()
        results = local_fn(base, state.lora_global, data_x, data_y, idx.to(dev))
        deltas = results.delta
        sync()
        t1 = time.perf_counter()
        agg_carry = state.agg_carry
        if plan is not None:
            update, agg_carry, ediag = engine_lib.aggregate_planned(
                plan, deltas, agg_carry or None, weights=w_all, with_diagnostics=True,
            )
            rpca_diags = rpca_diag_summary(ediag)
        elif agg_cfg.method == "fedrpca":
            update, ediag = aggregate(
                deltas, agg_cfg, engine=cfg.engine, weights=w_all, with_diagnostics=True,
                mesh=mesh, device=dev,
            )
            rpca_diags = rpca_diag_summary(ediag)
        else:
            update = aggregate(deltas, agg_cfg, engine=cfg.engine, weights=w_all, mesh=mesh,
                               device=dev, key=(cfg.seed, state.round_idx))
            rpca_diags = {}
        lora_global = tree_map(lambda g, u: g + u, state.lora_global, update)
        finite = torch.stack([torch.isfinite(u).all() for u in tree_leaves(update)]).all()
        sync()
        t2 = time.perf_counter()
        per_client = 4.0 * sum(int(np.prod(l.shape[1:])) for l in tree_leaves(deltas))
        diags = {
            "mean_local_loss": torch.mean(results.final_loss),
            **rpca_diags,
            "update_finite": finite.to(torch.float32),
            "bytes_up": per_client * n_clients,
            "bytes_down": per_client,
            "t_local_s": t1 - t0,
            "t_agg_s": t2 - t1,
            "t_overlap_s": 0.0,
            "t_round_s": t2 - t0,
        }
        new_state = state._replace(
            lora_global=lora_global,
            prev_local=results.lora,
            round_idx=state.round_idx + 1,
            agg_carry=agg_carry,
        )
        return new_state, diags

    round_fn.cohort_pad = n_clients
    round_fn.agg_plan = plan
    return round_fn


def run_simulation(
    base: Tree,
    lora_init: Tree,
    data_x,
    data_y,
    cfg: FedRunConfig,
    eval_fn: Callable[[Tree], float],
    *,
    eval_every: int = 1,
    log_fn: Optional[Callable[[int, dict], None]] = None,
    client_weights=None,
    n_active: Optional[int] = None,
    batch_indices: Optional[Callable[[int], Any]] = None,
    device="cuda",
):
    """Runs ``cfg.rounds`` rounds on ``device``; returns (final lora,
    accuracy history).

    ``base``, ``lora_init`` and the client data move to ``device`` (default
    ``"cuda"``; without CUDA this raises unless the caller passes
    ``device="cpu"``).  ``eval_fn(lora)`` scores the global model after
    every ``eval_every`` rounds and after the last; ``log_fn(r, diags)``
    gets the accuracy and the round's diagnostics, timers included.
    ``batch_indices`` injects the minibatch index stream (see
    ``make_round_fn``).  With ``carry_mode != "none"`` the rounds form one
    aggregation session planned from ``lora_init``, and the carry's
    diagnostics reach ``log_fn``.
    """
    dev = backend.resolve_device(device)
    data_x = torch.as_tensor(data_x).to(dev)
    data_y = torch.as_tensor(data_y).to(dev)
    base = tree_to(base, dev)
    lora_init = tree_to(lora_init, dev)
    n_clients = data_x.shape[0]
    if n_active is not None:
        raise ValueError(
            f"n_active={n_active} passed to a full-participation run "
            "(set clients_per_round to enable partial participation)"
        )
    round_fn = make_round_fn(
        base, data_x, data_y, cfg, client_weights=client_weights, batch_indices=batch_indices,
        lora_template=lora_init,
    )
    state = init_round_state(lora_init, n_clients, cfg.seed)
    history = []
    for r in range(cfg.rounds):
        state, diags = round_fn(state)
        if (r + 1) % eval_every == 0 or r == cfg.rounds - 1:
            acc = float(eval_fn(state.lora_global))
            history.append(acc)
            if log_fn:
                log_fn(r, {"acc": acc, **{k: float(v) for k, v in diags.items()}})
    return state.lora_global, np.asarray(history)


def rounds_to_reach(history: np.ndarray, frac: float = 0.9) -> int:
    """R@90-style metric: 1-based count of rounds until frac * final accuracy
    (-1 on an empty history, ``len(history)`` when never reached)."""
    if len(history) == 0:
        return -1
    target = frac * history[-1]
    hits = np.flatnonzero(history >= target)
    return int(hits[0]) + 1 if len(hits) else len(history)
