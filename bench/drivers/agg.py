"""Closed-loop server aggregation: calls of the FedRPCA session
(``launch.steps.make_agg_step``: ``core.engine`` plan and
``aggregate_planned``) back to back, each on a new round of planted client
deltas (``gen.planted``) and each ending in a synchronise.

The deltas have the shapes of the configuration's LoRA adapters (every
targeted projection of every layer, A and B), stacked over the mix's
clients, all of them valid.  Set-up drives the session through its first
``checked_calls`` calls (the warm-up, which warms the carry); the window
then makes each next round's deltas and aggregates them, so the window's
time holds the generator's few large draws beside each call.  Once the
window has closed, the plain reference session follows the checked calls
from the same deltas.
"""
from __future__ import annotations

import gc
import time

import torch

from bench.gen import planted
from bench.gen import weights as W
from bench.harness import checks, program, trace
from bench.reference import rpca as ref_rpca

FAULTS = ("unchanged", "half_batch", "altered")


def _blocks(spec: dict) -> dict:
    """{(target, factor): (L, vec)} of the configuration's adapters."""
    r, n_l = spec["lora"]["rank"], spec["n_layers"]
    return {(t, f): (n_l, (d_in if f == "A" else d_out) * r)
            for t, (d_in, d_out) in W.lora_dims(spec).items() for f in ("A", "B")}


def _tree(spec: dict, blocks: dict, n: int) -> dict:
    """The program's stacked delta tree from (L, vec, n) blocks."""
    r = spec["lora"]["rank"]
    lora = {}
    for t, (d_in, d_out) in W.lora_dims(spec).items():
        lora[t] = {"A": blocks[(t, "A")].permute(2, 0, 1).reshape(n, -1, d_in, r),
                   "B": blocks[(t, "B")].permute(2, 0, 1).reshape(n, -1, r, d_out)}
    return W.program_lora(lora)


def _modules(blocks: dict) -> list:
    """(vec, n) matrices in ``weights.modules`` order."""
    return [blocks[(t, f)][i] for t, f in sorted(blocks) for i in range(blocks[(t, f)].shape[0])]


def run(cell: dict, seed: int, seconds: float, trace_on: bool, device, clock0: float,
        fault=None, reference: bool = True) -> dict:
    from repro_torch.launch import steps
    from repro_torch.utils.pytree import tree_map

    spec, mix = cell["config"], cell["mix"]
    n = mix["clients"]
    is_cuda = torch.device(device).type == "cuda"
    gen = planted.Planted(_blocks(spec), n, mix["planted"], seed, device)
    agg_step = steps.make_agg_step(program.agg_config(mix), engine="packed")
    lora = W.program_lora(W.lora_init(spec, seed, device))
    from repro_torch.core import engine

    example = tree_map(lambda x: torch.zeros((n, *x.shape), dtype=x.dtype, device=device), lora)
    carry = engine.init_agg_carry(engine.plan_aggregation(example, program.agg_config(mix)))
    del lora, example

    mask = None
    if fault == "half_batch":
        mask = torch.zeros((n,), dtype=torch.float32, device=device)
        mask[: n // 2] = 1.0

    def call(r, carry):
        with trace.span("bench.gen"):
            blocks = gen.round(r)
        upd, metrics, new_carry = agg_step(_tree(spec, blocks, n), mask, (seed, r), carry)
        if fault == "unchanged":
            upd, new_carry = tree_map(torch.zeros_like, upd), carry
        elif fault == "altered":
            q = W.from_program_lora(upd)
            q[sorted(q)[0]]["B"][0].neg_()
        return blocks, upd, metrics, new_carry

    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    checked = []
    for r in range(mix["checked_calls"]):
        blocks, upd, _, carry = call(r, carry)
        checked.append(W.modules(W.from_program_lora(upd), stacked=False))
        if r == 0:
            cosine = planted.mean_pairwise_cosine(blocks)
    del blocks, upd
    if is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - clock0
    r, falls, resid = mix["checked_calls"], [], []
    while True:
        _, _, metrics, carry = call(r, carry)
        if is_cuda:
            torch.cuda.synchronize()
        falls.append(metrics["fallback_count"])
        resid.append(metrics["rpca_residual_max"])
        r += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    calls = r - mix["checked_calls"]
    falls = [float(f) for f in falls]
    record = {"window": {"seconds": elapsed, "calls": calls, "fallbacks": falls}}
    t_end = time.perf_counter()
    if trace_on:
        record["trace"], record["calls"] = _traced_tail(call, carry, r, mix)
        record["traced_calls"] = mix["traced_calls"]
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    t_traced = time.perf_counter()
    del carry, agg_step
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    failed = sum(1 for x in resid if not torch.isfinite(torch.as_tensor(x)).all())
    out = {"attempted": calls, "failed": failed, "memory_peak_bytes": peak, "setup_s": setup_s,
           "e2e": {"agg_s": elapsed / calls}, "record": record,
           "notes": {"mean pairwise cosine of the clients' deltas (round 0)": cosine}}
    if reference:
        want = follow(cell, seed, device, len(checked))
        readings = {"update_gap": compare(checked, want)}
        out["readings"], out["want"] = readings, want
        out["correct"], out["checks"] = checks.judge(readings, cell["checks"]["limits"])
    out["notes"]["seconds of set-up, window, traced tail, reference"] = [
        round(setup_s, 3), round(t_end - t0, 3), round(t_traced - t_end, 3),
        round(time.perf_counter() - t_traced, 3)]
    return out


def _traced_tail(call, carry, r0, mix):
    from repro_torch.kernels import svt_subspace

    spans = trace.Spans()
    box = [carry]

    def calls():
        for r in range(r0, r0 + mix["traced_calls"]):
            with trace.span("bench.call"):
                box[0] = call(r, box[0])[3]

    with spans.around(svt_subspace, "subspace_apply", "bench.subspace",
                      lambda m, *a, **kw: tuple(m.shape)):
        t = trace.capture(calls, tuple(spans.names))
    return t, dict(spans.calls)


def follow(cell: dict, seed: int, device, calls: int, dtype=torch.float64) -> list:
    """The reference session's updates (``weights.modules`` order) over the
    first ``calls`` rounds of the same planted deltas."""
    spec, mix = cell["config"], cell["mix"]
    gen = planted.Planted(_blocks(spec), mix["clients"], mix["planted"], seed, device)
    a = mix["aggregator"]
    session = ref_rpca.Session(ref_rpca.AggSettings(iters=a["rpca_iters"], rank=a["svt_rank"],
                                                    sweeps=a["svt_sweeps"]), dtype=dtype)
    return [ref_rpca.aggregate(session, _modules(gen.round(r))) for r in range(calls)]


def compare(got: list, want: list) -> float:
    """The worst module's relative gap ||u - u_ref|| / ||u_ref|| of the
    update over the checked calls (the aggregation is no chaotic training:
    its answers are compared element by element)."""
    return max(checks.worst_gap(g, w) for g, w in zip(got, want))
