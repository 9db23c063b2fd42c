"""Serving example: batched multi-tenant LoRA inference from an adapter pool
(twin of ``examples/serve_lora.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_lora [--device cpu]

Builds a reduced RecurrentGemma (hybrid RG-LRU + local attention — the
long-context-friendly family), publishes 3 tenant adapters into an
``AdapterPool``, and serves a mixed batch in ONE co-batched forward pass:
each request's adapter is read from the pool in place by slot index (the
gathered LoRA kernel), with no per-request tree re-stacking.

Then the fed->serve hot swap: one synthetic aggregation round runs through
``AggSession``, the update is published into tenant 0's slot (the pool keeps
its storage, so the same decode call serves the new adapter with nothing
rebuilt), and tenant 0's continuation changes, the other tenants' don't.
Runs on the card unless ``--device cpu`` is given; every weight, adapter and
delta is drawn on the CPU from a seed and then moved, so the card and the
CPU serve the same model.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import AggregatorConfig, AggSession
from repro_torch.kernels import backend
from repro_torch.models import decode_step, extend_caches, forward, init_lora_params, init_params
from repro_torch.serve import AdapterPool, adapter_view
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_to

BATCH, PROMPT, GEN, N_ADAPTERS = 4, 12, 8, 3


def main(batch=BATCH, prompt=PROMPT, gen=GEN, n_adapters=N_ADAPTERS, device="cuda"):
    dev = backend.resolve_device(device)
    cfg = get_config("recurrentgemma-2b").reduced()
    base = init_params(cfg, seed=0, device="cpu").to(dev)

    # Publish each tenant's adapter into the pool (slot-allocated, padded).
    pool = AdapterPool(init_lora_params(cfg, seed=0, device=dev), n_slots=n_adapters)
    tenant_trees = {}
    for i in range(n_adapters):
        tree = init_lora_params(cfg, seed=i, device="cpu")
        # Break the B=0 LoRA init so distinct tenants produce distinct logits.
        gen99 = torch.Generator().manual_seed(99)
        tree = tree_to(tree_map(lambda l: l + 0.05 * torch.randn(l.shape, generator=gen99,
                                                                  dtype=l.dtype), tree), dev)
        tenant_trees[i] = tree
        pool.publish(i, tree)
    print(f"pool: {len(pool)}/{pool.n_slots} slots resident, publishes={pool.publishes}")

    request_adapter = [i % n_adapters for i in range(batch)]
    slots = pool.acquire(request_adapter)

    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(batch, prompt)),
                              dtype=torch.int64, device=dev)

    # ONE forward per mixed-tenant batch: each request's adapter is read from
    # the pool by slot inside the gathered LoRA kernel.
    @torch.no_grad()
    def prefill(pooled, slots, tokens):
        logits, caches, _ = forward(base, adapter_view(pooled, slots), {"tokens": tokens}, cfg,
                                    mode="prefill")
        return logits, caches

    @torch.no_grad()
    def decode(pooled, slots, tok, caches, idx):
        return decode_step(base, adapter_view(pooled, slots), tok, caches, idx, cfg)

    def generate(caches, logits):
        caches = tree_map(torch.clone, caches)  # decode writes the caches in place
        tok = torch.argmax(logits[:, -1:], dim=-1)
        outs = [tok]
        for i in range(gen - 1):
            logits, caches = decode(pool.pooled, slots, tok, caches, prompt + i)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            outs.append(tok)
        return torch.cat(outs, dim=1).cpu().numpy()

    t0 = time.time()
    logits, caches = prefill(pool.pooled, slots, prompts)
    caches = extend_caches(caches, gen, cfg)
    print(f"prefill {batch} prompts x {prompt} tokens (co-batched): {time.time()-t0:.2f}s")
    prefill_caches = caches

    t0 = time.time()
    gen_tokens = generate(caches, logits)
    print(f"decoded {gen} tokens/request in {time.time()-t0:.2f}s")
    for i in range(batch):
        print(f"request {i} (adapter {request_adapter[i]}): {gen_tokens[i].tolist()}")

    # Sanity: per-tenant outputs differ from the merged-mean baseline.
    with torch.no_grad():
        merged_logits = forward(base, pool.merged(), {"tokens": prompts}, cfg,
                                mode="prefill")[0]
    diff = float(torch.max(torch.abs(merged_logits - logits)))
    assert diff > 1e-4, "per-tenant outputs should differ from the merged baseline"
    print(f"merged-baseline check: max |per-tenant - merged| logit gap = {diff:.3f}")

    # ---- fed -> serve hot swap ------------------------------------------
    # One synthetic aggregation round: client deltas for tenant 0, RPCA
    # aggregation, publish into the SAME pool slot, decode again with
    # nothing rebuilt.
    n_clients = 4
    deltas = []
    for c in range(n_clients):
        g = torch.Generator().manual_seed(7 + c)
        deltas.append(tree_to(tree_map(lambda l: 0.3 * torch.randn(l.shape, generator=g,
                                                                   dtype=l.dtype),
                                       tenant_trees[0]), dev))
    stacked = tree_map(lambda *xs: torch.stack(xs), *deltas)
    session = AggSession(AggregatorConfig(method="fedrpca", rpca_iters=5), device=dev)
    update, _ = session.step(stacked)

    storage = [x.data_ptr() for x in tree_leaves(pool.pooled)]
    publishes_before = pool.publishes
    tenant_trees[0] = pool.publish_round(0, tenant_trees[0], update, lr=1.0)
    assert [x.data_ptr() for x in tree_leaves(pool.pooled)] == storage, (
        "publish must write the slot in place")

    gen_after = generate(prefill_caches, logits)
    changed = [i for i in range(batch) if gen_after[i].tolist() != gen_tokens[i].tolist()]
    print(f"hot-swap: published aggregated round into slot 0 "
          f"(publishes={pool.publishes - publishes_before}, pool storage kept)")
    print(f"requests with changed continuations: {changed} "
          f"(tenant-0 requests: {[i for i in range(batch) if request_adapter[i] == 0]})")
    for i in changed:
        print(f"request {i} now: {gen_after[i].tolist()}")
    assert changed, "tenant-0 continuations should change after the round lands"
    assert all(request_adapter[i] == 0 for i in changed), (
        "only tenant-0 requests should change"
    )
    return gen_tokens, gen_after


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    cli()
