"""Host syncs a traced round: the program's reads of device values on the
host and its other waits for the card (``trace.host_read``, ``trace.sync``:
the ADMM gates, ``eigh``'s info, copies of host values to the card, the
round's timers), as the program counts them."""
from bench.harness.spans import counter


def read(record):
    return counter("host_syncs", "rounds")
