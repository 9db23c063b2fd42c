"""Percent of the traced calls in which no operation ran on the card (the
profiler's device timeline)."""
from bench.harness.readers import idle_share


def read(record):
    return idle_share(record)
