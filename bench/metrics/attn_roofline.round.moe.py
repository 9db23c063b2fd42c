"""Percent of the roofline of attention (``kernels.ops.local_attention``,
the pairs the causal mask keeps) over the device time under the
benchmark's span around that entry, in the traced rounds.
The same reading as ``attn_roofline.round``, in the cells that report ``round_s.moe``."""
from bench.harness.readers import roofline


def read(record):
    return roofline(record, "bench.attention")
