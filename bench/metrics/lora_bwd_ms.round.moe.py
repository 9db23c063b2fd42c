"""Device ms a traced round inside the program's ``repro.lora.backward``
spans (``kernels/lora_matmul.py::_LoraFn.backward``; CUDA event pairs).
The same reading as ``lora_bwd_ms.round``, in the cells that report ``round_s.moe``."""
from bench.harness.spans import device_ms


def read(record):
    return device_ms(["repro.lora.backward"], "rounds")
