"""Federated simulation: partitioning and client ranks, planted tasks,
clients, server loop, the round pipeline, the update quarantine, fault
injection and the sketch uplink codec."""
from repro_torch.fed import faults, guard, partition, pipeline, sketch, synth
from repro_torch.fed.client import LocalResult, LocalSpec, make_local_fn
from repro_torch.fed.faults import FaultConfig, FaultModel, make_deadline_sampler
from repro_torch.fed.guard import GuardConfig, screen
from repro_torch.fed.partition import (
    client_sizes,
    data_size_weights,
    dirichlet_partition,
    label_distribution,
)
from repro_torch.fed.pipeline import (
    AdaptiveStaleScale,
    AggWorker,
    InFlightQueue,
    run_rounds,
    stale_scale,
)
from repro_torch.fed.server import (
    SAMPLERS,
    FedRunConfig,
    LocalBundle,
    RoundPhases,
    RoundState,
    init_round_state,
    make_round_fn,
    make_round_phases,
    make_sampler,
    rounds_to_reach,
    run_simulation,
)

__all__ = [
    "LocalResult", "LocalSpec", "make_local_fn", "client_sizes", "data_size_weights",
    "dirichlet_partition", "label_distribution", "SAMPLERS", "FedRunConfig", "LocalBundle",
    "RoundPhases", "RoundState", "init_round_state", "make_round_fn", "make_round_phases",
    "make_sampler", "rounds_to_reach", "run_simulation", "AdaptiveStaleScale", "AggWorker",
    "FaultConfig", "FaultModel", "GuardConfig", "InFlightQueue", "make_deadline_sampler",
    "run_rounds", "screen", "stale_scale", "faults", "guard", "partition", "pipeline", "sketch",
    "synth",
]
