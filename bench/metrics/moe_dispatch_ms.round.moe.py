"""Device ms a traced round inside the program's MoE dispatch and combine
spans, each direction (``models/moe.py::apply_moe``: ``repro.moe.dispatch``,
``.combine``, ``.dispatch.backward``, ``.combine.backward``; CUDA event
pairs on the current stream)."""
from bench.harness.spans import device_ms

SPANS = ["repro.moe.dispatch", "repro.moe.combine", "repro.moe.dispatch.backward",
         "repro.moe.combine.backward"]


def read(record):
    return device_ms(SPANS, "rounds")
