"""Device milliseconds a traced call: the profiler's busy time over the
number of traced calls.  The device's share of ``agg_s``, which is paced
partly by the host and spreads from run to run far more than this."""


def read(record):
    tr, n = record.get("trace"), record.get("traced_calls")
    if tr is None or not n:
        return None
    return 1e3 * tr["busy_s"] / n
