"""Percent of the traced calls' device time spent in kernels launched
under ``aten::linalg_eigh`` (the exact-eigh steps of the ADMM loop)."""


def read(record):
    tr = record.get("trace")
    if tr is None or not tr["device_total_s"]:
        return None
    return 100.0 * tr["ops"].get("aten::linalg_eigh", 0.0) / tr["device_total_s"]
