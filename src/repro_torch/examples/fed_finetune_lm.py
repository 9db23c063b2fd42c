"""End-to-end example: federated LoRA fine-tuning of a ~100M-param LM (twin of
``examples/fed_finetune_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.fed_finetune_lm --rounds 60

A 97M-parameter dense transformer (12 layers, d_model 768, vocab 16k) is
fine-tuned with LoRA (r=8, Q/V) across 4 federated clients holding
heterogeneous Markov-LM shards; the server aggregates with FedRPCA through
the port's ``make_fed_train_step``.  A few hundred local steps total
(rounds x local_steps).  Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import LoRAConfig, ModelConfig
from repro_torch.core import AggregatorConfig
from repro_torch.data import client_lm_datasets
from repro_torch.kernels import backend
from repro_torch.launch import steps as steps_lib
from repro_torch.models import init_lora_params, init_params, loss_fn
from repro_torch.utils.pytree import tree_leaves

CFG_100M = ModelConfig(
    name="fedlm-97m",
    arch_type="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=16_384,
    dtype="float32",
    lora=LoRAConfig(rank=8, alpha=16.0, targets=("q", "v")),
    source="example: GPT-2-small-like federated target",
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--per-client-batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--aggregator", default="fedrpca")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = backend.resolve_device(args.device)

    cfg = CFG_100M
    base = init_params(cfg, seed=0, device=dev)
    lora = init_lora_params(cfg, seed=1, device=dev)
    n_base = sum(p.numel() for p in base.parameters())
    n_lora = sum(x.numel() for x in tree_leaves(lora))
    print(f"base params: {n_base/1e6:.1f}M, lora params: {n_lora/1e3:.1f}K")

    client_tokens, test = client_lm_datasets(
        args.clients, vocab_size=cfg.vocab_size, n_seqs=64, seq_len=args.seq,
        heterogeneity=0.6, seed=0,
    )
    step = steps_lib.make_fed_train_step(
        cfg,
        AggregatorConfig(method=args.aggregator, rpca_iters=30),
        local_lr=3e-3, local_steps=args.local_steps,
        local_optimizer="adam", remat=False,
    )
    tensor = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    test_batch = {"tokens": tensor(test.tokens[:8, :-1]), "labels": tensor(test.tokens[:8, 1:])}

    def eval_loss(l):
        with torch.no_grad():
            return loss_fn(base, l, test_batch, cfg, remat=False)[0]

    rng = np.random.default_rng(0)
    print(f"initial eval loss: {float(eval_loss(lora)):.4f}")
    for r in range(args.rounds):
        idx = rng.integers(0, client_tokens.shape[1],
                           size=(args.clients, args.per_client_batch))
        seqs = np.take_along_axis(client_tokens, idx[:, :, None], axis=1)
        batch = {"tokens": tensor(seqs[:, :, :-1]), "labels": tensor(seqs[:, :, 1:])}
        t0 = time.time()
        lora, metrics = step(base, lora, batch)
        if r % 5 == 0 or r == args.rounds - 1:
            print(
                f"round {r:03d}  local_loss={float(metrics['loss']):.4f}  "
                f"eval_loss={float(eval_loss(lora)):.4f}  ({time.time()-t0:.1f}s/round)",
                flush=True,
            )
        if args.ckpt_dir and (r + 1) % 20 == 0:
            save_checkpoint(lora, args.ckpt_dir, r + 1, metadata={"arch": cfg.name})
    total_steps = args.rounds * args.local_steps
    print(f"done: {args.rounds} rounds x {args.local_steps} local steps = "
          f"{total_steps} LoRA steps per client")


if __name__ == "__main__":
    main()
