"""Percent of the roofline of the gathered LoRA projection
(``kernels.ops.gathered_lora_matmul``) over the device time under the
benchmark's span around that entry, in the traced rounds.
The same reading as ``lora_roofline.round``, in the cells that report ``round_s.moe``."""
from bench.harness.readers import roofline


def read(record):
    return roofline(record, "bench.lora")
