"""Device ms a traced round inside the program's ``repro.lora.backward``
spans (``kernels/lora_matmul.py::_LoraFn.backward``, the plain backward of
every LoRA projection; CUDA event pairs on the current stream)."""
from bench.harness.spans import device_ms


def read(record):
    return device_ms(["repro.lora.backward"], "rounds")
