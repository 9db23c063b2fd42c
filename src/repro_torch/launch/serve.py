"""Multi-tenant LoRA serving entry point: adapter pool + request scheduler (port
of ``repro/launch/serve.py``).

Requests carry adapter ids; the scheduler co-batches across tenants and
resolves ids to pool slots (``repro_torch.serve.AdapterPool``).  Prefill and
greedy decode run one forward pass per mixed-tenant batch, in which every
adapted projection is one launch of the gathered LoRA kernel reading the
pool in place.  ``--merged`` serves the mean of all adapters instead
(``lora_matmul`` with one 2-D adapter).  ``--arch`` is ``stablelm-1.6b``
(attention blocks), ``mamba2-130m`` (SSD blocks, prefill through the
``ssd_scan`` kernel), ``recurrentgemma-2b`` (RG-LRU and sliding-window
attention blocks with a ring cache, two tail layers, GeGLU, MQA at head
width 256), the dense ``gemma-7b``, ``qwen1.5-32b`` and ``deepseek-67b``
(untied head), the MoE ``granite-moe-1b-a400m`` and
``llama4-maverick-400b-a17b`` (the whole batch routed as one group), the
encoder-decoder ``whisper-medium`` (prompts are decoder prefixes over stub
audio frames; the encoder runs once at prefill and each decoder layer
attends to its cross cache at decode) or ``qwen2-vl-2b`` (M-RoPE; stub
vision embeddings over the first 256 positions).  The stubs come from the
CLI's numpy generator after the prompts (``_make_batch``), so one
``--seed`` gives both packages the same inputs.  Any config serves with an
int8 KV cache when its ``kv_quant`` is set (``cfg.replace(kv_quant=True)``
for the serving functions).

On a card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
      --batch 8 --prompt-len 512 --gen 32 --n-adapters 4 --pool-slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
      --batch 8 --prompt-len 2560 --gen 32 --n-adapters 4 --pool-slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \\
      --batch 8 --prompt-len 416 --gen 32 --n-adapters 4 --pool-slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-2b \\
      --batch 8 --prompt-len 512 --gen 32 --n-adapters 4 --pool-slots 8
On the CPU, at the reduced size:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --reduced \\
      --device cpu --batch 4 --prompt-len 16 --gen 8 --n-adapters 3 --pool-slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b --reduced \\
      --device cpu --prompt-len 40
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium --reduced \\
      --device cpu --batch 4 --prompt-len 16 --gen 8 --n-adapters 3
"""
from __future__ import annotations

import argparse
import logging
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.kernels import backend
from repro_torch.models import decode_step, extend_caches, forward, init_lora_params, init_params
from repro_torch.serve import AdapterPool, adapter_view
from repro_torch.utils.pytree import tree_map

log = logging.getLogger("repro_torch.serve")


def gather_adapters(stacked_lora, request_ids):
    """Per-request adapters materialized by a gather over the stacked
    adapters' leading axis: (n_adapters, ...) -> (B, ...).  Serving does
    not take this path: the pool and ``adapter_view`` read each request's
    slot in place.  Kept as the reference keeps it, as a baseline."""
    ids = torch.as_tensor(request_ids, dtype=torch.int64)
    return tree_map(lambda leaf: leaf.index_select(0, ids.to(leaf.device)), stacked_lora)


@dataclass
class Request:
    """One serving request: a prompt bound to a tenant's adapter."""

    request_id: int
    adapter_id: object
    tokens: np.ndarray  # (prompt_len,) int


@dataclass
class RequestScheduler:
    """FIFO co-batching across tenants.

    ``next_batch`` takes up to ``batch_size`` queued requests regardless of
    tenant and resolves their adapter ids to slots, which also feeds the
    pool's LRU/traffic keys.  Tokens come back on the pool's device.
    """

    pool: AdapterPool
    batch_size: int
    queue: List[Request] = field(default_factory=list)

    def submit(self, request: Request):
        if request.adapter_id not in self.pool:
            raise KeyError(
                f"request {request.request_id}: adapter {request.adapter_id!r} "
                "not resident — publish() it before submitting"
            )
        self.queue.append(request)

    def next_batch(self) -> Optional[tuple]:
        if not self.queue:
            return None
        take, self.queue = self.queue[: self.batch_size], self.queue[self.batch_size:]
        tokens = torch.as_tensor(np.stack([r.tokens for r in take]), dtype=torch.int64,
                                 device=self.pool.device)
        slots = self.pool.acquire([r.adapter_id for r in take])
        return take, tokens, slots


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Next tokens (B, 1) from logits (B, S, V): argmax of the last position."""
    return torch.argmax(logits[:, -1:], dim=-1)


def _make_batch(cfg, tokens: torch.Tensor, rng) -> dict:
    """The prefill batch of ``tokens`` (B, S) with the config's frontend
    stub, drawn from the numpy generator ``rng`` in the reference's order
    and dtype: ``vision_embeds`` (B, n_vision_tokens, d_model) for a VLM,
    ``encoder_frames`` (B, encoder_seq, d_model) for an audio model, each
    N(0, 1) in float64 cast to ``cfg.dtype``."""
    batch = {"tokens": tokens}
    b = tokens.shape[0]
    stub = lambda n: torch.as_tensor(rng.normal(size=(b, n, cfg.d_model))).to(
        device=tokens.device, dtype=getattr(torch, cfg.dtype))
    if cfg.frontend in ("vision", "audio") and rng is None:
        raise ValueError(f"{cfg.name}: the {cfg.frontend} stub needs a numpy generator (rng)")
    if cfg.frontend == "vision":
        batch["vision_embeds"] = stub(cfg.n_vision_tokens)
    if cfg.frontend == "audio":
        batch["encoder_frames"] = stub(cfg.encoder_seq)
    return batch


def serve_batch(base, pool, scheduler, cfg, *, gen: int, prefill_fn, decode_fn, rng=None):
    """Drain one batch from the scheduler: prefill + greedy decode of
    ``gen`` tokens.  Returns (requests, tokens (B, gen)) or None.  ``rng``
    (a numpy generator) draws the frontend stubs (``_make_batch``); configs
    without a frontend take none."""
    item = scheduler.next_batch()
    if item is None:
        return None
    requests, tokens, slots = item
    logits, caches = prefill_fn(base, pool.pooled, slots, _make_batch(cfg, tokens, rng))
    caches = extend_caches(caches, gen, cfg)
    tok = greedy(logits)
    generated = [tok]
    prompt_len = tokens.shape[1]
    for i in range(gen - 1):
        logits, caches = decode_fn(base, pool.pooled, slots, tok, caches, prompt_len + i)
        tok = greedy(logits)
        generated.append(tok)
    return requests, torch.cat(generated, dim=1)


def make_serving_fns(cfg):
    """Prefill and decode over (base, pooled, slots, ...), plain functions:
    nothing is traced or compiled, and the pool is read at every call, so a
    publish between calls is seen by the next one."""

    def prefill(base, pooled, slots, batch):
        return forward(base, adapter_view(pooled, slots), batch, cfg, mode="prefill")[:2]

    def decode(base, pooled, slots, tok, caches, idx):
        return decode_step(base, adapter_view(pooled, slots), tok, caches, idx, cfg)

    return prefill, decode


def merge_adapter_means(adapters):
    """Single-tenant fallback: the mean of the adapter trees."""
    return tree_map(lambda *xs: torch.stack(xs).mean(dim=0), *adapters)


def serve_merged(base, lora, tokens, cfg, *, gen: int, rng=None):
    """Prefill + greedy decode with one 2-D adapter for every request (the
    ``--merged`` path), the frontend stubs drawn from ``rng``
    (``_make_batch``).  Returns tokens (B, gen)."""
    logits, caches, _ = forward(base, lora, _make_batch(cfg, tokens, rng), cfg, mode="prefill")
    caches = extend_caches(caches, gen, cfg)
    tok = greedy(logits)
    generated = [tok]
    for i in range(gen - 1):
        logits, caches = decode_step(base, lora, tok, caches, tokens.shape[1] + i, cfg)
        tok = greedy(logits)
        generated.append(tok)
    return torch.cat(generated, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="stablelm-1.6b",
                    help="stablelm-1.6b (default) or any id of repro_torch.configs")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--n-adapters", type=int, default=1)
    ap.add_argument("--pool-slots", type=int, default=0,
                    help="adapter pool capacity (0 = fit --n-adapters exactly)")
    ap.add_argument("--merged", action="store_true",
                    help="serve the MEAN of all adapters (every tenant gets the same "
                         "averaged adapter)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    device = backend.resolve_device(args.device)
    cfg = cfglib.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.encoder_decoder:
        log.info("enc-dec arch: prompts are decoder prefixes over stub audio frames")
    base = init_params(cfg, seed=args.seed, device=device)
    adapters = [init_lora_params(cfg, seed=args.seed + 10 + i, device=device)
                for i in range(args.n_adapters)]
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, size=(args.batch, args.prompt_len))

    def synced():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    if args.merged:
        log.warning("--merged: serving the MEAN of %d adapters — every request gets the "
                    "same averaged adapter; drop --merged for the pool path.",
                    args.n_adapters)
        t0 = synced()
        out = serve_merged(base, merge_adapter_means(adapters),
                           torch.as_tensor(prompts, device=device), cfg, gen=args.gen, rng=rng)
        dt = synced() - t0
        log.info("served %d requests (merged): %d tokens/req in %.2fs", args.batch,
                 args.gen, dt)
        log.info("sample continuation (req 0): %s", out[0].tolist())
        return out

    pool = AdapterPool(adapters[0], args.pool_slots or args.n_adapters)
    for i, tree in enumerate(adapters):
        pool.publish(f"tenant-{i}", tree)
    log.info("adapter pool: %d/%d slots resident", len(pool), pool.n_slots)
    scheduler = RequestScheduler(pool, args.batch)
    for i in range(args.batch):
        scheduler.submit(Request(i, f"tenant-{i % args.n_adapters}", prompts[i]))
    prefill_fn, decode_fn = make_serving_fns(cfg)
    t0 = synced()
    requests, out = serve_batch(base, pool, scheduler, cfg, gen=args.gen,
                                prefill_fn=prefill_fn, decode_fn=decode_fn, rng=rng)
    dt = synced() - t0
    log.info("served %d requests across %d tenants: %d tokens/req in %.2fs "
             "(%.1f tok/s aggregate)", len(requests), min(args.n_adapters, args.batch),
             args.gen, dt, len(requests) * args.gen / max(dt, 1e-9))
    for r, row in zip(requests[:4], out.tolist()):
        log.info("request %d (adapter %s): %s", r.request_id, r.adapter_id, row)
    return out


if __name__ == "__main__":
    main()
