"""Percent of the roofline of the fused subspace-SVT tail
(``kernels.svt_subspace.subspace_apply``) over the device time under the
benchmark's span around that entry, in the traced calls."""
from bench.harness.readers import roofline


def read(record):
    return roofline(record, "bench.subspace")
