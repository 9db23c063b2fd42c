"""How far an fp32 difference of the inputs moves federated rounds, on the CPU.

    PYTHONPATH=src python3 tools/round_sensitivity.py

Runs ``chip_smoke.py``'s path A task (768 x 768, LoRA rank 4, 20 clients,
Adam 1e-2, 8 local steps of 32) twice on the CPU: once as it is and once
with the backbone W0 multiplied entry by entry by (1 + 1e-7 z), z standard
normal from a fixed seed, about the size of the difference between two
devices' reduction orders.  It prints, for FedAvg and each client
objective:

- ``rounds3``: the largest |difference| of the global LoRA after 3 whole
  rounds (how far two devices' runs part ways);
- for one round from the same start, the global LoRA's and the per-client
  local models' largest excess over |difference| <= 1e-3 |value| + 1e-5
  (positive: the element-wise bound fails) and the per-client fields'
  difference relative to each leaf's norm.

These numbers set how ``chip_smoke.py`` holds the card against the CPU in
path H (``PhaseCheck``, ``STATE_FRO_RTOL``).  A CPU run measures no device
time; only the differences it prints mean anything.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.fed import init_round_state, make_round_fn, synth  # noqa: E402

METHODS = (("fedavg", "fedavg", {}), ("fedprox", "fedavg", dict(fedprox_mu=0.01)),
           ("scaffold", "fedavg", dict(scaffold=True)), ("moon", "fedavg", dict(moon_mu=0.1)),
           ("fedrpca", "fedrpca", {}), ("fedrpca+fedprox", "fedrpca", dict(fedprox_mu=0.01)))


def excess(a: dict, b: dict) -> float:
    return max(float(((a[k] - b[k]).abs() - 1e-3 * b[k].abs() - 1e-5).max()) for k in a)


def main() -> None:
    task = cs.make_task("cpu")
    z = torch.randn(task.base["W0"].shape, generator=torch.Generator().manual_seed(0))
    nudged = task._replace(base={**task.base, "W0": task.base["W0"] * (1 + 1e-7 * z)})
    for label, method, local_kw in METHODS:
        runs = [cs.run_fed(t, method, "gram", 3, "cpu", local_kw=local_kw)[0]
                for t in (task, nudged)]
        rounds3 = max(float((runs[0][k] - runs[1][k]).abs().max()) for k in runs[0])
        states = []
        for t in (task, nudged):
            cfg = cs.fed_config(t, method, "gram", 1, local_kw=local_kw)
            round_fn = make_round_fn(t.base, t.client_x, t.client_y, cfg)
            states.append(round_fn(init_round_state(synth.init_lora(t, seed=0),
                                                    t.client_x.shape[0], 0))[0])
        a, b = states
        print(f"{label}: rounds3 {rounds3:.3g}; one round: global excess "
              f"{excess(a.lora_global, b.lora_global):.3g}, local models excess "
              f"{excess(a.prev_local, b.prev_local):.3g}, of the norm "
              f"{cs.rel_fro(a.prev_local, b.prev_local):.3g}", flush=True)


if __name__ == "__main__":
    main()
