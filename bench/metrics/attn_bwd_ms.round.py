"""Device ms a traced round inside the program's
``repro.attention.backward`` spans (``kernels/local_attention.py::
_AttentionFn.backward``, which recomputes the plain attention under
autograd; CUDA event pairs on the current stream)."""
from bench.harness.spans import device_ms


def read(record):
    return device_ms(["repro.attention.backward"], "rounds")
