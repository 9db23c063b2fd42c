"""Federated simulation: partitioning, planted tasks, clients, server loop."""
from repro_torch.fed import partition, synth
from repro_torch.fed.client import LocalResult, LocalSpec, make_local_fn
from repro_torch.fed.server import (
    FedRunConfig,
    RoundState,
    init_round_state,
    make_round_fn,
    rounds_to_reach,
    run_simulation,
)

__all__ = [
    "partition", "synth", "LocalResult", "LocalSpec", "make_local_fn", "FedRunConfig",
    "RoundState", "init_round_state", "make_round_fn", "rounds_to_reach", "run_simulation",
]
