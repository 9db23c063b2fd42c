"""Server round loop: broadcast -> batched local runs -> aggregate -> update.

Port of ``repro/fed/server.py``.  A round is two independently dispatchable
phases (``make_round_phases``): a *local phase* — sample the cohort, run the
batched client optimization, emit the stacked deltas — and an *aggregation
phase* — screen, aggregate and scale the update, consuming and producing the
cross-round carry.  ``make_round_fn`` composes the two back to back (the
synchronous round); ``run_simulation`` drives them through
``pipeline.run_rounds``, which with ``cfg.pipeline`` overlaps a round's local
phase with the previous rounds' aggregations.

Partial participation pads the cohort to a canonical size
(``stacking.canonical_cohort_size``): the sampler fills ``cohort_pad``
slots, of which the first ``n_active`` (further restricted by the sampler's
own slot validity) are valid; masked slots skip their local work and
leave every per-client state alone.

Randomness on the host: minibatch indices and cohorts come from the round
state's CPU ``torch.Generator`` seeded with ``cfg.seed`` (so the same seed
draws the same batches and cohorts on every device), or from the
``batch_indices`` / ``cohorts`` callables a caller injects (a parity test
passes the reference's ``jax.random`` draws).  DARE's key for round t is
``(cfg.seed, t)``; fault draws are a pure function of (fault seed, round)
(``fed.faults``).  ``mesh_shards > 1`` shards every aggregation's client
axis over ``launch.mesh.make_host_mesh(mesh_shards)`` on the run's device.
``uplink="sketch[:k[:tol]]"`` sends each client column through the
carry-basis sketch codec (``fed.sketch``) inside a carrying fedrpca session;
``client_ranks`` zero-masks each client's delta beyond its declared rank.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import engine as engine_lib
from repro_torch.core import stacking
from repro_torch.core.aggregators import (
    CARRY_MODES,
    WEIGHTINGS,
    AggregatorConfig,
    aggregate,
    client_flag_vector,
    rpca_diag_summary,
)
from repro_torch.fed import faults as faults_lib
from repro_torch.fed import guard as guard_lib
from repro_torch.fed import partition as partition_lib
from repro_torch.fed import sketch as sketch_lib
from repro_torch.fed.client import LocalSpec, make_local_fn
from repro_torch.fed.faults import top_k_stable
from repro_torch.kernels import backend
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_to, tree_zeros_like

Tree = Any


class RoundState(NamedTuple):
    lora_global: Tree
    scaffold_c: Tree
    scaffold_ci: Tree  # (M, ...) per-client variates
    prev_local: Tree  # (M, ...) previous-round local models (MOON)
    rng: torch.Generator  # CPU generator of the default index and cohort streams
    round_idx: int = 0
    agg_carry: Any = ()


class LocalBundle(NamedTuple):
    """One local phase's hand-off to the aggregation phase.

    ``deltas`` are the stacked per-slot client deltas; ``mask`` / ``weights``
    the cohort validity mask and per-client aggregation weights (None on the
    dense / unweighted paths); ``agg_key`` the round's DARE key
    ``(seed, round)``; ``loss_mean`` the masked mean of the clients' final
    local losses; ``fault_slots`` the clients whose deltas the fault model
    corrupted ((cohort,) float32, None with injection off).
    """

    deltas: Tree
    mask: Any
    weights: Any
    agg_key: Any
    loss_mean: torch.Tensor
    fault_slots: Any = None


class RoundPhases:
    """The split server round.

    ``local(state, n_active=None) -> (state', LocalBundle)`` runs the client
    optimization and all the round bookkeeping that does not depend on the
    aggregation (SCAFFOLD variates, MOON's previous models, the generator,
    the round counter); ``state'`` keeps the input ``lora_global`` and
    ``agg_carry``, so a pipelined schedule may run the next local phase before
    the previous aggregation lands.

    ``agg(agg_carry, bundle, scale) -> (scaled_update, carry', diags)``
    returns the *scaled update*, not the applied state; ``apply(lora_global,
    scaled_update)`` adds it.  ``scale=1.0`` is the unscaled update bit for
    bit.  ``fallback(bundle, scale) -> (scaled_update, cold_carry, diags)``
    is plain masked FedAvg over the screened deltas, the supervisor's last
    rung; ``cold_carry()`` the bitwise-cold carry of its retry.
    """

    def __init__(self, local, agg, *, cohort_pad, plan, prep_state, apply, fallback,
                 cold_carry):
        self.local = local
        self.agg = agg
        self.cohort_pad = cohort_pad
        self.plan = plan
        self.prep_state = prep_state
        self.apply = apply
        self.fallback = fallback
        self.cold_carry = cold_carry


@dataclasses.dataclass(frozen=True)
class FedRunConfig:
    """Field for field the reference's run configuration."""

    aggregator: AggregatorConfig
    local: LocalSpec
    rounds: int
    seed: int = 0
    clients_per_round: int = 0  # 0 = full participation (the paper's setting)
    engine: str = "packed"  # "packed" | "reference"
    sampler: str = "uniform"  # client sampler (see SAMPLERS)
    # Overlap each round's local phase with up to ``staleness`` in-flight
    # aggregations (fed.pipeline); staleness=0 is the synchronous schedule.
    pipeline: bool = False
    staleness: int = 1
    # ``faults``: a fed.faults.FaultConfig (None = no injection).  ``guard``:
    # None = the quarantine is on exactly when faults are injected, a
    # fed.guard.GuardConfig = on with those thresholds, False = off.
    faults: Any = None
    guard: Any = None
    mesh_shards: int = 0
    # Compressed uplink codec: "dense" (the plain wire), "sketch[:k[:tol]]"
    # or a fed.sketch.UplinkConfig.  Sketch mode needs a carrying packed
    # fedrpca round (the codec projects onto the carried basis); otherwise
    # it runs dense with a warning.
    uplink: Any = "dense"
    # Heterogeneous per-client LoRA ranks: None = uniform, else a
    # fed.partition.parse_client_ranks spec (cycled over the clients).
    # Client i's delta is zero-masked beyond rank_i before aggregation.
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


# ---------------------------------------------------------------------------
# Client samplers: every sampler fills the same cohort_pad slots; only the
# cohort indices and the validity of each slot vary.
# ---------------------------------------------------------------------------

#: Built-in sampler kinds for ``FedRunConfig.sampler`` / ``make_sampler``.
SAMPLERS = ("uniform", "trace", "size_weighted")


def make_sampler(kind: str, n_clients: int, cohort_pad: int, *, availability=None,
                 weights=None) -> Callable:
    """Build a client sampler ``(generator, round_idx) -> (cohort,
    slot_valid)``: ``cohort`` a (cohort_pad,) int64 CPU index vector without
    repeats, ``slot_valid`` a (cohort_pad,) float32 CPU validity factor.
    Draws come from the CPU ``generator``; top-k is a stable descending sort
    (ties to the lower index, as ``jax.lax.top_k``).

    * ``uniform`` — prefix of a random permutation.
    * ``trace`` — ``availability`` is a ``(n_clients,)`` or ``(rounds,
      n_clients)`` 0/1 array; the round's row (cycled by ``round_idx``)
      restricts sampling to available clients, uniformly.  Available
      clients sort first, and ``slot_valid`` zeroes any slot beyond the
      round's availability head-count.
    * ``size_weighted`` — without-replacement sampling proportional to
      ``weights`` by the Gumbel-top-k trick.
    """
    if kind == "uniform":

        def sample(gen, round_idx):
            cohort = torch.randperm(n_clients, generator=gen)[:cohort_pad]
            return cohort, torch.ones((cohort_pad,), dtype=torch.float32)

        return sample
    if kind == "size_weighted":
        if weights is None:
            raise ValueError("sampler='size_weighted' requires client weights")
        logw = torch.log(torch.clamp_min(
            torch.as_tensor(np.asarray(weights), dtype=torch.float32).cpu(), 1e-12))

        def sample(gen, round_idx):
            u = torch.clamp_min(torch.rand((n_clients,), generator=gen), 1e-12)
            gumbel = -torch.log(-torch.log(u))
            return top_k_stable(logw + gumbel, cohort_pad), torch.ones((cohort_pad,))

        return sample
    if kind == "trace":
        if availability is None:
            raise ValueError("sampler='trace' requires an availability trace")
        avail = torch.as_tensor(np.asarray(availability), dtype=torch.float32).cpu()
        if avail.ndim == 1:
            avail = avail[None]
        if avail.shape[-1] != n_clients:
            raise ValueError(
                f"availability trace covers {avail.shape[-1]} clients, expected {n_clients}"
            )

        def sample(gen, round_idx):
            row = avail[int(round_idx) % avail.shape[0]]
            # Available clients draw a uniform score in [0, 1); unavailable
            # ones score below it, so they sort last.
            score = torch.where(row > 0, torch.rand((n_clients,), generator=gen),
                                torch.full((n_clients,), -1.0))
            cohort = top_k_stable(score, cohort_pad)
            return cohort, (row[cohort] > 0).to(torch.float32)

        return sample
    raise ValueError(f"unknown sampler: {kind!r} (expected one of {SAMPLERS})")


def _check_config(cfg: FedRunConfig, n_clients: int) -> None:
    """Validate the run configuration."""
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


def make_round_phases(
    base: Tree, data_x, data_y, cfg: FedRunConfig, client_weights=None, availability=None,
    lora_template: Tree | None = None, batch_indices: Optional[Callable[[int], Any]] = None,
    cohorts: Optional[Callable[[int], Any]] = None, fault_draws: Optional[Callable] = None,
) -> RoundPhases:
    """Build the split server round on the device of ``data_x``.

    Same arguments as ``make_round_fn``, which composes the returned phases;
    see its docstring.
    """
    n_clients, n_local = data_x.shape[0], data_x.shape[1]
    _check_config(cfg, n_clients)
    dev = data_x.device
    local_fn = make_local_fn(cfg.local)
    sample_size = cfg.clients_per_round or n_clients
    partial = sample_size < n_clients
    cohort_pad = min(stacking.canonical_cohort_size(sample_size), n_clients)
    slots = cohort_pad if partial else n_clients

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

    # Full participation never samples: no sampler is built (nor its inputs
    # validated).
    sampler = None
    if partial:
        sampler = make_sampler(cfg.sampler, n_clients, cohort_pad, availability=availability,
                               weights=client_weights)

    # Fault model and quarantine: the guard is on exactly when faults are
    # injected unless cfg.guard says otherwise; its energy threshold folds
    # into the aggregator so both engines down-weight suspect clients.
    fault_model = None
    if cfg.faults is not None and cfg.faults.active:
        fault_model = faults_lib.FaultModel(cfg.faults, draws=fault_draws)
    guard_cfg = cfg.guard
    if guard_cfg is None:
        guard_cfg = guard_lib.GuardConfig() if fault_model is not None else None
    elif guard_cfg is False:
        guard_cfg = None
    if guard_cfg is not None and guard_cfg.energy_k > 0:
        agg_cfg = agg_cfg.replace(guard_energy_k=guard_cfg.energy_k)
    deadline_cohort = fault_model is not None and cfg.faults.straggler > 0 and partial
    if deadline_cohort:
        # Over-sample candidates, seat the earliest arrivals, zero this
        # round's stragglers, buffer late arrivals into the next cohort.
        inner = make_sampler(cfg.sampler, n_clients, min(2 * cohort_pad, n_clients),
                             availability=availability, weights=client_weights)
        sampler = faults_lib.make_deadline_sampler(fault_model, inner, n_clients, cohort_pad)

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
            mesh = make_host_mesh(cfg.mesh_shards, device=dev)

    # Heterogeneous ranks: 0/1 masks applied to the deltas in the local
    # phase, so the aggregation sees what rank-r_i clients zero-padded into
    # the uniform layout would ship.
    rank_masks = ranks_all = None
    if cfg.client_ranks is not None:
        if lora_template is None:
            raise ValueError(
                "client_ranks needs the LoRA structure to build the rank masks: pass "
                "lora_template= (e.g. the lora_init given to init_round_state)"
            )
        r_dim = partition_lib.infer_lora_rank(lora_template)
        ranks_all = partition_lib.parse_client_ranks(cfg.client_ranks, n_clients, r_dim)
        rank_masks = partition_lib.client_rank_masks(tree_to(lora_template, dev), ranks_all,
                                                     r_dim)
    carry_on = (agg_cfg.carry_mode != "none" and cfg.engine == "packed"
                and agg_cfg.method == "fedrpca")
    uplink_cfg = None
    if cfg.uplink is not None:
        uplink_cfg = sketch_lib.parse_uplink(cfg.uplink)
        if uplink_cfg.active and not carry_on:
            warnings.warn(
                "uplink sketch mode needs a carrying packed-engine fedrpca round (the "
                "codec projects onto the carried basis); running dense",
                stacklevel=2,
            )
            uplink_cfg = None

    # Cross-round carry: packed-engine fedrpca only (the reference engine is
    # the stateless parity oracle).
    plan = None
    if carry_on:
        if lora_template is None:
            raise ValueError(
                f"carry_mode={agg_cfg.carry_mode!r} needs the LoRA structure to plan the "
                "session: pass lora_template= (e.g. the lora_init given to init_round_state)"
            )
        example = tree_map(
            lambda x: torch.zeros((slots, *x.shape), dtype=x.dtype, device=dev), lora_template,
        )
        plan = engine_lib.plan_aggregation(
            example, agg_cfg, mesh=mesh, uplink=uplink_cfg,
            client_ranks=None if ranks_all is None else ranks_all.tolist(),
        )

    def draw_round(state: RoundState, n_active):
        """The round's cohort (None = everyone), CPU validity mask and
        minibatch indices, drawn in that order."""
        r = state.round_idx
        cohort = mask = None
        if partial:
            na = sample_size if n_active is None else int(n_active)
            cohort, slot_valid = cohorts(r) if cohorts is not None else sampler(state.rng, r)
            cohort = torch.as_tensor(np.array(cohort), dtype=torch.int64)
            slot_valid = torch.as_tensor(np.array(slot_valid), dtype=torch.float32)
            if tuple(cohort.shape) != (cohort_pad,) or tuple(slot_valid.shape) != (cohort_pad,):
                raise ValueError(f"round {r}: cohort of {tuple(cohort.shape)} slots, "
                                 f"expected ({cohort_pad},)")
            mask = (torch.arange(cohort_pad) < na).to(torch.float32) * slot_valid
        if batch_indices is None:
            idx = torch.randint(0, n_local, (slots, cfg.local.local_steps, cfg.local.batch_size),
                                generator=state.rng)
        else:
            idx = torch.as_tensor(np.array(batch_indices(r)), dtype=torch.int64)
        return cohort, mask, idx

    def local_phase(state: RoundState, n_active=None):
        r = state.round_idx
        cohort, mask_cpu, idx = draw_round(state, n_active)
        if cohort is None:
            take = lambda t: t
            x, y = data_x, data_y
        else:
            cdev = cohort.to(dev)
            take = lambda t: tree_map(lambda v: v.index_select(0, cdev), t)
            x, y = data_x.index_select(0, cdev), data_y.index_select(0, cdev)
        results = local_fn(base, state.lora_global, x, y, idx.to(dev), c=state.scaffold_c,
                           ci=take(state.scaffold_ci), prev_lora=take(state.prev_local),
                           active=mask_cpu)
        weights = None if w_all is None else take(w_all)

        if mask_cpu is None:
            n_eff = float(n_clients)
            new_ci, new_prev = results.new_ci, results.lora
            loss_mean = torch.mean(results.final_loss)
            mask = None
        else:
            mask = mask_cpu.to(dev)
            n_eff = torch.clamp_min(torch.sum(mask), 1.0)
            # Only valid slots write back: masked padding keeps old state.
            rows = torch.nonzero(mask_cpu > 0).flatten()
            dst, src = cohort[rows].to(dev), rows.to(dev)
            scatter = lambda full, part: tree_map(
                lambda f, p: f.clone().index_copy_(0, dst, p.index_select(0, src)), full, part)
            new_ci = scatter(state.scaffold_ci, results.new_ci)
            new_prev = scatter(state.prev_local, results.lora)
            loss_mean = torch.sum(mask * results.final_loss) / n_eff
        new_c = state.scaffold_c
        if cfg.local.scaffold:
            # c <- c + |S|/M * mean_S(ci_new - ci_old)   (SCAFFOLD eq. 5)
            frac = n_eff / n_clients
            old_ci = take(state.scaffold_ci)
            bmask = (lambda v: 1.0) if mask is None else (
                lambda v: mask.reshape((slots,) + (1,) * (v.ndim - 1)))
            delta_ci = tree_map(lambda new, old: torch.sum(bmask(new) * (new - old), dim=0) / n_eff,
                                results.new_ci, old_ci)
            new_c = tree_map(lambda c, d: c + frac * d, state.scaffold_c, delta_ci)
        # lora_global and agg_carry pass through unchanged: the aggregation
        # phase owns both.
        new_state = state._replace(scaffold_c=new_c, scaffold_ci=new_ci, prev_local=new_prev,
                                   round_idx=r + 1)
        deltas = results.delta
        if rank_masks is not None:
            deltas = tree_map(lambda d, mk: d * take(mk).to(d.dtype), deltas, rank_masks)
        bundle_mask = mask
        fault_slots = None
        if (fault_model is not None or guard_cfg is not None) and bundle_mask is None:
            # Fault and guard rounds are masked rounds.
            bundle_mask = torch.ones((n_clients,), dtype=torch.float32, device=dev)
        if fault_model is not None:
            deltas, bundle_mask, fault_slots = fault_model.inject(
                r, deltas, bundle_mask, stragglers=not deadline_cohort)
        bundle = LocalBundle(deltas=deltas, mask=bundle_mask, weights=weights,
                             agg_key=(cfg.seed, r), loss_mean=loss_mean, fault_slots=fault_slots)
        return new_state, bundle

    def screen_bundle(bundle: LocalBundle):
        # Layer-one quarantine: fold non-finite and norm-outlier clients into
        # the mask and zero their columns.
        if guard_cfg is None:
            return bundle.deltas, bundle.mask, None, {}
        deltas, mask2, g = guard_lib.screen(bundle.deltas, bundle.mask, guard_cfg)
        flags = g.pop("flags")
        return deltas, mask2, flags, g

    def update_diags(scaled, sflags, eflags, bundle: LocalBundle, sdiags):
        diags = dict(sdiags)
        diags["update_finite"] = torch.stack(
            [torch.isfinite(u).all() for u in tree_leaves(scaled)]).all().to(torch.float32)
        if bundle.fault_slots is not None:
            flags = sflags
            if eflags is not None:
                flags = eflags if flags is None else torch.maximum(flags, eflags)
            injected = bundle.fault_slots
            diags["fault_injected"] = torch.sum(injected)
            if flags is not None:
                diags["fault_caught"] = torch.sum(flags * injected)
        return diags

    def wire_diags(diags, deltas, mask2):
        # A sketch round's engine already counted its exact bytes up; any
        # other round ships the dense f32 payload of every live client.  Down:
        # the update broadcast once, plus the sketch basis multicast.
        per_client = 4.0 * sum(int(np.prod(l.shape[1:])) for l in tree_leaves(deltas))
        n_live = float(n_clients) if mask2 is None else torch.clamp_min(torch.sum(mask2), 0.0)
        if "bytes_up" not in diags:
            diags["bytes_up"] = per_client * n_live
        diags["bytes_down"] = per_client + diags.pop("bytes_down_basis", 0.0)
        return diags

    def scale_tree(tree, scale):
        return tree_map(lambda u: scale * u, tree)

    def agg_phase(agg_carry, bundle: LocalBundle, scale):
        deltas, mask2, sflags, sdiags = screen_bundle(bundle)
        eflags = None
        if plan is not None:
            update, new_carry, ediag = engine_lib.aggregate_planned(
                plan, deltas, agg_carry or None, key=bundle.agg_key, mask=mask2,
                weights=bundle.weights, with_diagnostics=True,
            )
            rpca_diags, eflags = rpca_diag_summary(ediag), client_flag_vector(ediag)
        else:
            new_carry = agg_carry
            kw = dict(engine=cfg.engine, key=bundle.agg_key, mask=mask2, weights=bundle.weights,
                      mesh=mesh, device=dev)
            if agg_cfg.method == "fedrpca":
                update, ediag = aggregate(deltas, agg_cfg, with_diagnostics=True, **kw)
                rpca_diags, eflags = rpca_diag_summary(ediag), client_flag_vector(ediag)
            else:
                update, rpca_diags = aggregate(deltas, agg_cfg, **kw), {}
        scaled = scale_tree(update, scale)
        diags = {**rpca_diags, **update_diags(scaled, sflags, eflags, bundle, sdiags)}
        return scaled, new_carry, wire_diags(diags, deltas, mask2)

    def apply_phase(lora_global, scaled_update):
        return tree_map(lambda g, su: g + su, lora_global, scaled_update)

    def cold_carry():
        return engine_lib.init_agg_carry(plan) if plan is not None else ()

    # The supervisor's last rung: plain masked FedAvg over the screened
    # deltas, no RPCA, no energy guard.
    fedavg_cfg = agg_cfg.replace(method="fedavg", guard_energy_k=0.0)

    def fallback_phase(bundle: LocalBundle, scale):
        deltas, mask2, sflags, sdiags = screen_bundle(bundle)
        update = aggregate(deltas, fedavg_cfg, engine=cfg.engine, key=bundle.agg_key,
                           mask=mask2, weights=bundle.weights, mesh=mesh, device=dev)
        scaled = scale_tree(update, scale)
        diags = {**update_diags(scaled, sflags, None, bundle, sdiags), "degraded": 1.0}
        return scaled, cold_carry(), wire_diags(diags, deltas, mask2)

    def prep_state(state: RoundState) -> RoundState:
        if plan is not None and isinstance(state.agg_carry, tuple) and not state.agg_carry:
            # First call of a carry session: materialize the empty carry.
            state = state._replace(agg_carry=engine_lib.init_agg_carry(plan))
        return state

    def local(state: RoundState, n_active=None):
        if n_active is not None:
            if not partial:
                raise ValueError(
                    f"n_active={n_active} passed to a full-participation round "
                    "(set clients_per_round to enable partial participation)"
                )
            if not 1 <= int(n_active) <= cohort_pad:
                raise ValueError(
                    f"n_active={n_active} out of range for the canonical cohort of "
                    f"{cohort_pad} slots (expected 1 <= n_active <= {cohort_pad})"
                )
        return local_phase(prep_state(state), n_active)

    return RoundPhases(local, agg_phase, cohort_pad=cohort_pad, plan=plan, prep_state=prep_state,
                       apply=apply_phase, fallback=fallback_phase, cold_carry=cold_carry)


def make_round_fn(
    base: Tree, data_x, data_y, cfg: FedRunConfig, client_weights=None, availability=None,
    lora_template: Tree | None = None, batch_indices: Optional[Callable[[int], Any]] = None,
    cohorts: Optional[Callable[[int], Any]] = None, fault_draws: Optional[Callable] = None,
) -> Callable:
    """Returns fn: (RoundState, n_active=None) -> (RoundState, diagnostics).

    The synchronous round on the device of ``data_x``: ``make_round_phases``'s
    local and aggregation phases back to back with ``scale=1.0``.

    ``client_weights`` are per-client data sizes (or any nonnegative
    weights): they feed the aggregation under ``weighting="data_size"`` /
    ``"data_size_rpca"`` and the ``size_weighted`` sampler.
    ``availability`` is the 0/1 trace of the ``trace`` sampler.

    ``batch_indices(round_idx)`` returns the round's (slots, local_steps,
    batch_size) minibatch indices, ``cohorts(round_idx)`` its (cohort,
    slot_valid) pair of ``cohort_pad`` slots; None draws each from the
    state's generator.  ``fault_draws`` replaces the fault model's draws
    (``fed.faults.FaultModel``).

    With partial participation, ``n_active`` overrides the cohort size at
    call time (1 <= n_active <= cohort_pad, else it raises); masked slots
    skip their local work and return exact zero deltas.

    ``carry_mode != "none"`` with the packed engine and fedrpca needs
    ``lora_template`` (one client's LoRA tree, e.g. the ``lora_init`` of
    ``init_round_state``) to plan the session once; the per-bucket carry
    then rides on ``RoundState.agg_carry`` and the diagnostics gain
    ``fallback_count``, ``live_rank_mean`` and ``carry_hit_rate``.  The
    reference engine ignores ``carry_mode``.
    """
    phases = make_round_phases(
        base, data_x, data_y, cfg, client_weights=client_weights, availability=availability,
        lora_template=lora_template, batch_indices=batch_indices, cohorts=cohorts,
        fault_draws=fault_draws,
    )

    def round_fn(state: RoundState, n_active=None):
        state, bundle = phases.local(state, n_active)
        upd, new_carry, diags = phases.agg(state.agg_carry, bundle, 1.0)
        state = state._replace(lora_global=phases.apply(state.lora_global, upd),
                               agg_carry=new_carry)
        return state, {"mean_local_loss": bundle.loss_mean, **diags}

    round_fn.cohort_pad = phases.cohort_pad
    round_fn.agg_plan = phases.plan
    round_fn.phases = phases
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
    availability=None,
    n_active: Optional[int] = None,
    batch_indices: Optional[Callable[[int], Any]] = None,
    cohorts: Optional[Callable[[int], Any]] = None,
    fault_draws: Optional[Callable] = None,
    device="cuda",
):
    """Runs ``cfg.rounds`` rounds on ``device``; returns (final lora,
    accuracy history).

    ``base``, ``lora_init`` and the client data move to ``device`` (default
    ``"cuda"``; without CUDA this raises unless the caller passes
    ``device="cpu"``).  Every run drives ``pipeline.run_rounds`` over the
    split phases: ``cfg.pipeline=False`` the synchronous schedule,
    ``cfg.pipeline=True`` up to ``cfg.staleness`` aggregations in flight.
    ``eval_fn(lora)`` scores the global model after every ``eval_every``
    rounds and after the last; ``log_fn(r, diags)`` gets the accuracy, the
    round's diagnostics and its timers (``t_local_s``, ``t_agg_s``,
    ``t_overlap_s``, ``t_round_s``).  ``n_active`` overrides the cohort size
    (partial participation only).  The other arguments are
    ``make_round_fn``'s.
    """
    from repro_torch.fed import pipeline as pipeline_lib

    dev = backend.resolve_device(device)
    data_x = torch.as_tensor(data_x).to(dev)
    data_y = torch.as_tensor(data_y).to(dev)
    base = tree_to(base, dev)
    lora_init = tree_to(lora_init, dev)
    phases = make_round_phases(
        base, data_x, data_y, cfg, client_weights=client_weights, availability=availability,
        lora_template=lora_init, batch_indices=batch_indices, cohorts=cohorts,
        fault_draws=fault_draws,
    )
    if n_active is not None and not 1 <= int(n_active) <= phases.cohort_pad:
        raise ValueError(
            f"n_active={n_active} out of range for the canonical cohort of "
            f"{phases.cohort_pad} slots"
        )
    state = init_round_state(lora_init, data_x.shape[0], cfg.seed)
    history = []

    def on_round(r, round_state, diags):
        if (r + 1) % eval_every == 0 or r == cfg.rounds - 1:
            acc = float(eval_fn(round_state.lora_global))
            history.append(acc)
            if log_fn:
                log_fn(r, {"acc": acc, **{k: float(v) for k, v in diags.items()}})

    state = pipeline_lib.run_rounds(
        phases, state, cfg.rounds, staleness=cfg.staleness if cfg.pipeline else 0,
        n_active=n_active, on_round=on_round,
    )
    return state.lora_global, np.asarray(history)


def rounds_to_reach(history: np.ndarray, frac: float = 0.9) -> int:
    """R@90-style metric: 1-based count of rounds until frac * final accuracy
    (-1 on an empty history, ``len(history)`` when never reached)."""
    if len(history) == 0:
        return -1
    target = frac * history[-1]
    hits = np.flatnonzero(history >= target)
    return int(hits[0]) + 1 if len(hits) else len(history)
