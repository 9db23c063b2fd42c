"""Closed-loop federated rounds: the synchronous round (every client's
local Adam steps, then the FedRPCA session) back to back through
``fed.pipeline.run_rounds``, each round ending in a synchronise.

Set-up makes the weights, the global adapter and the clients' token
streams from the seed, builds the round, and drives it through its first
``checked_rounds`` rounds (the warm-up, which also warms the session's
carry); the window then runs that same round for ``--seconds``.  Once the
window has closed and the program is freed, the plain reference follows
the checked rounds from the same inputs.

Round r gives client c the sequences ``order[c, (r P + j) % n_seqs]``, j <
P, of a per-client permutation, so no two rows of the checked rounds
repeat.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench.gen import markov
from bench.gen import weights as W
from bench.harness import checks, program, trace
from bench.reference import fedround as ref_round
from bench.reference import rpca as ref_rpca
from bench.work import counts

FAULTS = ("unchanged", "half_batch", "altered")


def client_batches(mix: dict, spec: dict, seed: int, device):
    """``batch_of(r)``: round r's (M, P, S + 1) token ids on ``device``."""
    toks = markov.client_tokens(mix["clients"], min(spec["vocab_size"], mix["vocab_cap"]),
                                mix["n_seqs"], mix["seq"], mix["heterogeneity"], seed)
    toks = torch.as_tensor(toks, device=device)
    rng = np.random.default_rng(W.sub_seed(seed, "order"))
    order = np.stack([rng.permutation(mix["n_seqs"]) for _ in range(mix["clients"])])
    p = mix["per_client_batch"]

    def batch_of(r: int) -> torch.Tensor:
        idx = torch.as_tensor(order[:, [(r * p + j) % mix["n_seqs"] for j in range(p)]],
                              device=device)
        return torch.stack([toks[c, idx[c]] for c in range(mix["clients"])])

    return batch_of


def _fault_hooks(fault, captured: dict):
    """Hooks that capture the checked rounds' outputs (while
    ``captured["on"]``) and, for a fault, break the timed path underneath."""
    from repro_torch.utils.pytree import tree_map

    def local(bundle):
        if fault == "unchanged":
            bundle = bundle._replace(deltas=tree_map(torch.zeros_like, bundle.deltas))
        elif fault == "altered":
            q = bundle.deltas["groups"][0]["mixer"]
            q[sorted(q)[0]]["B"][0, 0].neg_()  # client 0's first layer: an answer flipped
        if captured["on"]:
            captured["rounds"].append({
                "deltas": tree_map(lambda x: x.detach().clone(), bundle.deltas),
                "loss": bundle.loss_mean})
        return bundle

    def agg(upd):
        if captured["on"]:
            captured["rounds"][-1]["update"] = tree_map(lambda x: x.detach().clone(), upd)
        return upd

    return {"local": local, "agg": agg}


def _adam_reader(captured: dict):
    """The program's Adam, with the first gradient of each local phase read
    from its state after one step (m_1 = (1 - b1) g_1) while
    ``captured["on"]``; the update is the optimizer's own."""
    from repro_torch.launch import steps
    from repro_torch.optim.optimizers import Optimizer
    from repro_torch.utils.pytree import tree_map

    orig = steps.adam

    def adam(lr, b1=0.9, b2=0.999, eps=1e-8):
        opt = orig(lr, b1, b2, eps)

        def update(grads, state, params=None):
            upd, st = opt.update(grads, state, params)
            if captured["on"] and st["step"] == 1:
                captured["grads"].append(tree_map(lambda m: m / (1 - b1), st["m"]))
            return upd, st

        return Optimizer(opt.init, update)

    return steps, orig, adam


def _program(cell, seed, device, fault, captured):
    from repro_torch.models.model import DecoderLM

    spec, mix = cell["config"], cell["mix"]
    pcfg = program.port_config(spec)
    model = DecoderLM(pcfg, None, device=device)
    wts = W.base_weights(spec, seed, device)
    W.load_into(model, spec, wts)
    del wts
    lora = W.program_lora(W.lora_init(spec, seed, device))
    batch_of = client_batches(mix, spec, seed, device)
    if fault == "half_batch":
        full = batch_of
        batch_of = lambda r: full(r)[:, : mix["per_client_batch"] // 2]
    phases, empty_carry = program.round_phases(model, pcfg, mix, seed, batch_of,
                                               _fault_hooks(fault, captured))
    state = program.RoundState(lora, empty_carry(lora), 0)
    return model, phases, state


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell: dict, seed: int, seconds: float, trace_on: bool, device, clock0: float,
        fault=None, reference: bool = True) -> dict:
    from repro_torch.fed.pipeline import run_rounds

    mix = cell["mix"]
    is_cuda = torch.device(device).type == "cuda"
    captured = {"on": True, "rounds": [], "grads": []}
    model, phases, state = _program(cell, seed, device, fault, captured)
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    steps_mod, adam_orig, adam_reading = _adam_reader(captured)
    steps_mod.adam = adam_reading
    try:
        for _ in range(mix["checked_rounds"]):
            state = run_rounds(phases, state, 1)
    finally:
        steps_mod.adam = adam_orig
    captured["on"] = False
    for rec, g in zip(captured["rounds"], captured["grads"]):
        rec["grads"] = g
    diags = []
    on_round = lambda r, s, d: diags.append(d)
    _sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - clock0
    n = 0
    while True:
        state = run_rounds(phases, state, 1, on_round=on_round)
        n += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    record = {"window": {"seconds": elapsed, "rounds": n,
                         "t_local_s": [d["t_local_s"] for d in diags],
                         "t_agg_s": [d["t_agg_s"] for d in diags]}}
    finite = [bool(np.isfinite(float(d["mean_local_loss"])))
              and bool(np.isfinite(float(d["rpca_residual_max"]))) for d in diags]
    spec = cell["config"]
    record["work"] = {"round_flops": counts.local_phase_flops(
        spec, mix["clients"], mix["per_client_batch"], mix["seq"], mix["local_steps"])}
    t_end = time.perf_counter()
    if trace_on:
        record["trace"], record["calls"] = _traced_tail(phases, state, mix)
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    t_traced = time.perf_counter()
    rounds = captured["rounds"]
    del model, phases, state, captured
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    out = {"attempted": n, "failed": finite.count(False), "memory_peak_bytes": peak,
           "setup_s": setup_s, "e2e": {"round_s": elapsed / n}, "record": record}
    if reference:
        want = follow(cell, seed, device, len(rounds))
        readings = compare(rounds, want)
        out["readings"], out["want"] = readings, want
        out["correct"], out["checks"] = checks.judge(readings, cell["checks"]["limits"])
    out["notes"] = {"seconds of set-up, window, traced tail, reference": [
        round(setup_s, 3), round(t_end - t0, 3), round(t_traced - t_end, 3),
        round(time.perf_counter() - t_traced, 3)]}
    return out


def _traced_tail(phases, state, mix):
    import types

    from repro_torch.fed.pipeline import run_rounds
    from repro_torch.kernels import ops, svt_subspace

    spans = trace.Spans()

    def lora_shapes(x, w, a, b, slots, scale=1.0):
        return (int(x.numel() // x.shape[-1]), x.shape[-1], w.shape[-1], a.shape[-1], a.shape[0])

    def attn_shapes(q, k, v, *, window=0, causal=True):
        return (q.shape[0] * q.shape[2], k.shape[0] * k.shape[2], q.shape[1], q.shape[3],
                causal, window)

    def sub_shapes(m, *a, **kw):
        return tuple(m.shape)

    traced = types.SimpleNamespace(**vars(phases))

    def local(s, n_active=None):
        with trace.span("bench.local"):
            return phases.local(s, n_active)

    def agg(c, b, sc):
        with trace.span("bench.agg"):
            return phases.agg(c, b, sc)

    traced.local, traced.agg = local, agg
    box = [state]

    def rounds():
        for _ in range(mix["traced_rounds"]):
            box[0] = run_rounds(traced, box[0], 1)

    with spans.around(ops, "gathered_lora_matmul", "bench.lora", lora_shapes), \
            spans.around(ops, "local_attention", "bench.attention", attn_shapes), \
            spans.around(svt_subspace, "subspace_apply", "bench.subspace", sub_shapes):
        t = trace.capture(rounds, tuple(spans.names))
    return t, dict(spans.calls)


def follow(cell: dict, seed: int, device, rounds: int, quant=None) -> list:
    """The reference's first ``rounds`` rounds from the seed's inputs:
    per round the clients' mean last-step loss, and (``weights.modules``
    order) their first-step gradients and deltas, (vec, n_clients) a
    module, and the update vectors."""
    spec, mix = cell["config"], cell["mix"]
    torch.backends.cuda.matmul.allow_tf32 = False
    wts = W.base_weights(spec, seed, device, dtype=torch.float32)
    lora = {t: {f: x.float() for f, x in ab.items()}
            for t, ab in W.lora_init(spec, seed, device).items()}
    glob = ref_round.to_layers(lora)
    targets = sorted(lora)
    batch_of = client_batches(mix, spec, seed, device)
    a = mix["aggregator"]
    session = ref_rpca.Session(ref_rpca.AggSettings(iters=a["rpca_iters"], rank=a["svt_rank"],
                                                    sweeps=a["svt_sweeps"]))
    out = []
    for r in range(rounds):
        losses, grads, deltas = ref_round.local_phase(wts, glob, batch_of(r), spec,
                                                      mix["local_lr"], mix["local_steps"], quant)
        mats = ref_round.stack_modules(deltas, targets)
        upd = ref_rpca.aggregate(session, [m.double() for m in mats])
        glob = ref_round.apply_modules(glob, upd, targets)
        out.append({"loss": float(np.mean(losses)), "grads": ref_round.stack_modules(grads, targets),
                    "deltas": mats, "update": upd})
    del wts
    return out


def _as_modules(rec: dict) -> dict:
    """A round's outputs as module lists, from the program's trees."""
    if isinstance(rec["deltas"], list):
        return rec
    mods = lambda t, st: W.modules(W.from_program_lora(t), stacked=st)
    return {"loss": float(rec["loss"]), "grads": mods(rec["grads"], True),
            "deltas": mods(rec["deltas"], True), "update": mods(rec["update"], False)}


def compare(got: list, want: list) -> dict:
    """The numbers compared, each the worst over the checked rounds: the
    relative gap of the clients' mean loss; and, by the worst leaf (one
    client's matrix of one module, or one module's update), for the first
    gradient, the delta after the local steps and the update, the gap
    between the program's norm and the reference's (``*_gap``) and the norm
    of their difference (``*_diff``), each over the larger of the
    reference's norm of that leaf and of the median leaf.  Leaves whose
    reference gradient is under a thousandth of the median leaf's (the
    adapters' A while B is still zero) are left out of the gradient's."""
    out = {"loss_gap": 0.0}
    for g, w in zip(got, want):
        g = _as_modules(g)
        out["loss_gap"] = max(out["loss_gap"], abs(g["loss"] - w["loss"]) / abs(w["loss"]))
        for key, name, cols in (("grads", "grad", True), ("deltas", "delta", True),
                                ("update", "update", False)):
            gap, diff = checks.leaf_gaps(g[key], w[key], columns=cols,
                                         skip_below=1e-3 if key == "grads" else 0.0)
            out[name + "_gap"] = max(out.get(name + "_gap", 0.0), gap)
            out[name + "_diff"] = max(out.get(name + "_diff", 0.0), diff)
    return out

