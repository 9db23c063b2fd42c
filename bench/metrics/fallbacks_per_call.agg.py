"""Mean exact-eigh SVT steps a call in the window (the session's
``fallback_count``, ``core.aggregators.rpca_diag_summary``)."""
from bench.harness.readers import mean


def read(record):
    return mean(record["window"].get("fallbacks", []))
