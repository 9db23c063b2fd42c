"""Mean host-clock seconds of the aggregation step and its apply a round
in the window (``fed.pipeline.run_rounds``'s ``t_agg_s``, timers on), in
ms.
The same reading as ``agg_ms.round``, in the cells that report ``round_s.moe``."""
from bench.harness.readers import mean


def read(record):
    m = mean(record["window"].get("t_agg_s", []))
    return None if m is None else 1e3 * m
