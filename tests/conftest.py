import os
import sys
import types

# Tests run single-device CPU (the dry-run owns the 512-device trick in its
# own process — never set xla_force_host_platform_device_count here).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# Optional-dependency guard: when `hypothesis` is missing, install a minimal
# shim so `from hypothesis import given, settings, strategies as st` still
# imports and each @given test runs as a seeded-example test (a handful of
# deterministic draws instead of a property search).  The container this
# suite ships in bakes only jax/numpy/pytest; requirements.txt lists
# hypothesis for dev machines / CI where the real search is wanted.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:  # pragma: no cover - exercised only without hypothesis
    _N_EXAMPLES = 5

    class _Strategy:
        def __init__(self, sampler):
            self._sampler = sampler

        def draw(self, rng):
            return self._sampler(rng)

    def _integers(lo, hi):
        return _Strategy(lambda rng: int(rng.integers(lo, hi + 1)))

    def _floats(lo, hi, **_kw):
        return _Strategy(lambda rng: float(rng.uniform(lo, hi)))

    def _booleans():
        return _Strategy(lambda rng: bool(rng.integers(0, 2)))

    def _sampled_from(seq):
        items = list(seq)
        return _Strategy(lambda rng: items[int(rng.integers(0, len(items)))])

    def _lists(elem, min_size=0, max_size=10, **_kw):
        def sample(rng):
            n = int(rng.integers(min_size, max_size + 1))
            return [elem.draw(rng) for _ in range(n)]

        return _Strategy(sample)

    def _given(*args, **strategies):
        if args:
            raise TypeError("hypothesis shim supports keyword strategies only")

        def deco(fn):
            def runner():
                rng = np.random.default_rng(0)
                for _ in range(_N_EXAMPLES):
                    fn(**{k: s.draw(rng) for k, s in strategies.items()})

            # Deliberately no functools.wraps: the runner must present a
            # zero-arg signature so pytest doesn't look for fixtures named
            # after the strategy parameters.
            runner.__name__ = fn.__name__
            runner.__doc__ = fn.__doc__
            return runner

        return deco

    def _settings(*_a, **_kw):
        return lambda fn: fn

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _st.booleans = _booleans
    _st.sampled_from = _sampled_from
    _st.lists = _lists

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.__is_shim__ = True

    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    # Tests of the CUDA kernels themselves: they skip (inside the test)
    # when no card is present.
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")
