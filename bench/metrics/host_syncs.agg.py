"""Host syncs a traced aggregation call (``repro.agg.call``): the ADMM
loop's gates, ``eigh``'s reads of its info and the copies of host values to
the card, as the program counts them (``host_syncs``)."""
from bench.harness.spans import counter


def read(record):
    return counter("host_syncs", "calls")
