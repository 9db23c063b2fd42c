"""What a run may not have loaded: the JAX stack and the JAX package that
the port was made from.  Names are compared whole, by the part before the
first dot, so ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
