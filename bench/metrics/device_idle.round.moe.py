"""Percent of the traced rounds in which no operation ran on the card
(the profiler's device timeline).
The same reading as ``device_idle.round``, in the cells that report ``round_s.moe``."""
from bench.harness.readers import idle_share


def read(record):
    return idle_share(record)
