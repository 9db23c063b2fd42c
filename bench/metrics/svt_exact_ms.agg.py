"""Device ms a traced aggregation call inside the program's
``repro.rpca.svt_exact`` spans (``core/rpca.py::_exact_projector``, the
exact-eigh SVT steps of the ADMM loop; CUDA event pairs on the current
stream, so device idle inside a step counts)."""
from bench.harness.spans import device_ms


def read(record):
    return device_ms(["repro.rpca.svt_exact"], "calls")
