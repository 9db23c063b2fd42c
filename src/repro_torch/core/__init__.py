"""FedRPCA core: Robust-PCA decomposition + server-side aggregation."""
from repro_torch.core.rpca import (
    RPCAResult,
    SVT_MODES,
    SubspaceState,
    SVTSubspaceResult,
    batched_robust_pca,
    robust_pca,
    robust_pca_bucket,
    robust_pca_fixed_iters,
    soft_threshold,
    subspace_init,
    svt_gram,
    svt_gram_batched,
    svt_subspace,
    svt_subspace_step,
    svt_svd,
)
from repro_torch.core.aggregators import (
    CARRY_MODES,
    ENGINES,
    METHODS,
    WEIGHTINGS,
    AggregatorConfig,
    aggregate,
    fedavg,
    fedrpca,
    rpca_diag_summary,
    sparse_energy_ratio,
    task_arithmetic,
)
from repro_torch.core.engine import (
    Bucket,
    EngineDiagnostics,
    PackEntry,
    PackSpec,
    aggregate_packed,
    pack,
    unpack,
)
from repro_torch.core import metrics, stacking

__all__ = [
    "RPCAResult", "SVT_MODES", "SubspaceState", "SVTSubspaceResult",
    "batched_robust_pca", "robust_pca", "robust_pca_bucket", "robust_pca_fixed_iters",
    "soft_threshold", "subspace_init", "svt_gram", "svt_gram_batched", "svt_subspace",
    "svt_subspace_step", "svt_svd",
    "CARRY_MODES", "ENGINES", "METHODS", "WEIGHTINGS", "AggregatorConfig", "aggregate",
    "fedavg", "fedrpca", "rpca_diag_summary", "sparse_energy_ratio", "task_arithmetic",
    "Bucket", "EngineDiagnostics", "PackEntry", "PackSpec", "aggregate_packed", "pack",
    "unpack", "metrics", "stacking",
]
