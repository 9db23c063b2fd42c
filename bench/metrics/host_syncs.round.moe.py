"""Host syncs a traced round, as the program counts them (``host_syncs``).
The same reading as ``host_syncs.round``, in the cells that report ``round_s.moe``."""
from bench.harness.spans import counter


def read(record):
    return counter("host_syncs", "rounds")
