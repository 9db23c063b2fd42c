"""The benchmark's side of the program's interface: the configuration as
the program takes it, and the federated round wired as the program's
training CLI wires it (``launch.steps`` local and aggregation steps driven
by ``fed.pipeline.run_rounds``)."""
from __future__ import annotations

import types
from typing import Any, NamedTuple

import torch

#: Configuration-file fields handed to the program's ``ModelConfig`` as
#: they are.
FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size",
          "norm_kind", "norm_eps", "rope_pct", "rope_theta", "ffn_kind", "n_experts",
          "top_k", "capacity_factor", "router_aux_weight", "tie_embeddings", "qkv_bias",
          "dtype")


def port_config(spec: dict):
    """The program's ``ModelConfig`` for a configuration file: its
    architecture id with every stated field set as the file states it."""
    from repro_torch import configs
    from repro_torch.config import LoRAConfig

    lo = spec["lora"]
    return configs.get_config(spec["arch"]).replace(
        layer_pattern=("attn",), **{k: spec[k] for k in FIELDS},
        lora=LoRAConfig(rank=lo["rank"], alpha=float(lo["alpha"]), targets=tuple(lo["targets"]),
                        dtype=lo["dtype"]))


def agg_config(mix: dict):
    from repro_torch.core import AggregatorConfig

    a = mix["aggregator"]
    return AggregatorConfig(method=a["method"], rpca_iters=a["rpca_iters"],
                            svt_mode=a["svt_mode"], svt_rank=a["svt_rank"],
                            svt_sweeps=a["svt_sweeps"], carry_mode=a["carry_mode"])


class RoundState(NamedTuple):
    lora_global: Any
    agg_carry: Any
    round_idx: int


class Bundle(NamedTuple):
    deltas: Any
    mask: Any
    round_key: Any
    loss_mean: Any


def round_phases(model, pcfg, mix: dict, seed: int, batch_of, hooks=None):
    """``run_rounds`` phases of the synchronous federated round, and the
    empty session carry.  ``batch_of(r)`` is round r's (M, P, S + 1) token
    ids.  ``hooks`` may hold ``local(bundle) -> bundle`` and
    ``agg(update) -> update``, applied to what the phases hand on (the
    checks' fault injection and capture)."""
    from repro_torch.core import engine
    from repro_torch.launch import steps
    from repro_torch.utils.pytree import tree_map

    hooks = hooks or {}
    agg = agg_config(mix)
    local_step = steps.make_local_step(pcfg, local_lr=mix["local_lr"],
                                       local_steps=mix["local_steps"], local_optimizer="adam",
                                       remat=mix["remat"])
    agg_step = steps.make_agg_step(agg, engine="packed")

    def local(state: RoundState, n_active=None):
        r = state.round_idx
        b = batch_of(r)
        key = (seed, 1000 + r)
        deltas, loss, mask = local_step(model, state.lora_global,
                                        {"tokens": b[..., :-1], "labels": b[..., 1:]}, key)
        bundle = Bundle(deltas, mask, key, loss)
        if "local" in hooks:
            bundle = hooks["local"](bundle)
        return state._replace(round_idx=r + 1), bundle

    def agg_phase(carry, bundle: Bundle, scale):
        upd, metrics, new_carry = agg_step(bundle.deltas, bundle.mask, bundle.round_key, carry,
                                           scale)
        if "agg" in hooks:
            upd = hooks["agg"](upd)
        return upd, new_carry, metrics

    def empty_carry(lora):
        n = mix["clients"]
        example = tree_map(lambda x: torch.zeros((n, *x.shape), dtype=x.dtype, device=x.device),
                           lora)
        return engine.init_agg_carry(engine.plan_aggregation(example, agg))

    phases = types.SimpleNamespace(local=local, agg=agg_phase, prep_state=lambda s: s,
                                   apply=steps.apply_update)
    return phases, empty_carry
