"""Quickstart: FedRPCA vs FedAvg on a planted-signal federated task (twin of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds a 16-client non-IID task (Dirichlet alpha=0.3), runs 20 federated
LoRA rounds under both aggregators, and prints the accuracy trajectories —
the short version of the paper's Table 1.  Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import AggregatorConfig
from repro_torch.fed import FedRunConfig, LocalSpec, run_simulation, synth
from repro_torch.kernels import backend
from repro_torch.optim import make_optimizer


def main(rounds: int = 20, n_clients: int = 16, rpca_iters: int = 40, local_steps: int = 8,
         device="cuda"):
    """Run the comparison; the defaults are the demo scale, and the
    keywords let a test drive a reduced run of the same code path."""
    dev = backend.resolve_device(device)
    task = synth.make_synth_task(n_clients=n_clients, alpha=0.3, seed=0, device=dev)
    eval_fn = lambda lora: synth.accuracy(task.base, lora, task.test_x, task.test_y,
                                          task.lora_scale)
    local = LocalSpec(
        loss_fn=lambda base, lora, b: synth.loss_fn(base, lora, b, task.lora_scale),
        optimizer=make_optimizer("adam", 1e-2),
        local_steps=local_steps,
        batch_size=32,
        lr=1e-2,
    )
    print(f"zero-shot accuracy: {float(eval_fn(synth.init_lora(task))):.3f}")
    for method in ("fedavg", "fedrpca"):
        cfg = FedRunConfig(
            aggregator=AggregatorConfig(method=method, rpca_iters=rpca_iters),
            local=local, rounds=rounds, seed=0,
        )
        _, hist = run_simulation(task.base, synth.init_lora(task), task.client_x, task.client_y,
                                 cfg, eval_fn, device=dev)
        stride = max(rounds // 5, 1)
        print(f"{method:8s} final={hist[-1]:.3f}  trajectory={np.round(hist[::stride], 3)}")


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    cli()
