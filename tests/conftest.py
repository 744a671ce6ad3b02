"""Test-suite bootstrap.

The container may lack ``hypothesis``; rather than failing collection for
every module that imports it, install a minimal stub whose ``@given`` tests
skip at runtime. Property tests run for real wherever hypothesis exists.
"""
import sys
import types


try:  # pragma: no cover - depends on environment
    import hypothesis  # noqa: F401
except ImportError:  # pragma: no cover
    import pytest

    hyp = types.ModuleType("hypothesis")
    strat = types.ModuleType("hypothesis.strategies")

    def given(*_a, **_k):
        def deco(fn):
            # plain zero-arg wrapper: @wraps would expose the strategy
            # parameters in the signature and pytest would demand fixtures
            def skipper():
                pytest.skip("hypothesis not installed")
            skipper.__name__ = fn.__name__
            skipper.__doc__ = fn.__doc__
            return skipper
        return deco

    def settings(*_a, **_k):
        def deco(fn):
            return fn
        return deco

    def _strategy(*_a, **_k):
        return None

    hyp.given = given
    hyp.settings = settings
    hyp.strategies = strat
    for name in ("integers", "floats", "booleans", "sampled_from", "lists",
                 "text", "tuples", "one_of", "just"):
        setattr(strat, name, _strategy)
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = strat


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips with a reason without one)")
