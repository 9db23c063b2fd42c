"""Reductions of the program's own trace (``repro_torch.utils.trace``: the
spans and counters it keeps while the traced tail's profiler records) for
the per-layer metrics that read it.  ``run.py`` calls the readers in the
driver's process once the driver has returned.  Each reduction returns
None where the program keeps no such trace (a checkout from before it) or
recorded no round or call, or none of the spans asked for; the metric is
then left out of the result."""
from __future__ import annotations


def summary():
    """The program's ``trace.summary()``, or None without that module."""
    try:
        from repro_torch.utils import trace
    except ImportError:
        return None
    return trace.summary()


def device_ms(names, per: str, s=None):
    """Device ms under the spans ``names`` (each span's CUDA event pairs,
    summed) over the ``per`` recorded: ``"rounds"`` or ``"calls"``."""
    s = summary() if s is None else s
    if s is None or not s[per]:
        return None
    vals = [s["spans"][n]["device_ms"] for n in names if n in s["spans"]]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / s[per]


def counter(name: str, per: str, s=None):
    """The counter ``name`` over the ``per`` recorded (0 where a recorded
    round or call never counted it)."""
    s = summary() if s is None else s
    if s is None or not s[per]:
        return None
    return s["counters"].get(name, 0) / s[per]
