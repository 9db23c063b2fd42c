"""Paper-reproduction example: all aggregators + client-side baselines head-
to-head on one heterogeneous task (twin of ``examples/compare_aggregators.py``).

    PYTHONPATH=src python -m repro_torch.examples.compare_aggregators --rounds 30

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import AggregatorConfig
from repro_torch.fed import FedRunConfig, LocalSpec, rounds_to_reach, run_simulation, synth
from repro_torch.kernels import backend
from repro_torch.optim import make_optimizer

METHODS = {
    "fedavg": (dict(method="fedavg"), {}),
    "fedprox": (dict(method="fedavg"), dict(fedprox_mu=0.01)),
    "scaffold": (dict(method="fedavg"), dict(scaffold=True)),
    "moon": (dict(method="fedavg"), dict(moon_mu=0.1)),
    "task_arith": (dict(method="task_arithmetic", beta=2.0), {}),
    "ties": (dict(method="ties", ties_keep=0.1), {}),
    "fedrpca": (dict(method="fedrpca", adaptive_beta=True, rpca_iters=40), {}),
    "rpca+prox": (dict(method="fedrpca", rpca_iters=40), dict(fedprox_mu=0.01)),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rpca-iters", type=int, default=40,
                    help="ADMM iterations for the fedrpca rows (smoke tests "
                         "pass a small value)")
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = backend.resolve_device(args.device)

    task = synth.make_synth_task(
        n_clients=args.clients, alpha=args.alpha, seed=args.seed,
        pretrain_quality=0.55, noise=0.3, device=dev,
    )
    eval_fn = lambda lora: synth.accuracy(task.base, lora, task.test_x, task.test_y,
                                          task.lora_scale)
    feats = lambda base, lora, x: synth.features(base, lora, x, task.lora_scale)
    print(f"clients={args.clients} alpha={args.alpha} "
          f"zero-shot={float(eval_fn(synth.init_lora(task))):.3f}\n")
    print(f"{'method':<12} {'final':>7} {'R@90':>5}  trajectory")
    rows = []
    for name, (agg_kw, local_kw) in METHODS.items():
        agg_kw = dict(agg_kw)
        if agg_kw.get("method") == "fedrpca":
            agg_kw["rpca_iters"] = args.rpca_iters
        local = LocalSpec(
            loss_fn=lambda base, lora, b: synth.loss_fn(base, lora, b, task.lora_scale),
            optimizer=make_optimizer("adam", 1e-2),
            local_steps=args.local_steps, batch_size=32, lr=1e-2,
            feature_fn=feats, **local_kw,
        )
        cfg = FedRunConfig(aggregator=AggregatorConfig(**agg_kw), local=local,
                           rounds=args.rounds, seed=0)
        _, hist = run_simulation(task.base, synth.init_lora(task), task.client_x, task.client_y,
                                 cfg, eval_fn, device=dev)
        rows.append((name, hist[-1]))
        print(f"{name:<12} {hist[-1]:>7.4f} {rounds_to_reach(hist):>5}  "
              f"{np.round(hist[:: max(args.rounds // 6, 1)], 3)}")
    best = max(rows, key=lambda r: r[1])
    print(f"\nbest: {best[0]} ({best[1]:.4f})")


if __name__ == "__main__":
    main()
