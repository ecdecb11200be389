"""Shared fixtures. NOTE: no XLA_FLAGS here on purpose — tests run on the
single real CPU device; multi-device tests spawn subprocesses that set
--xla_force_host_platform_device_count themselves."""

import numpy as np
import pytest

try:
    from hypothesis import HealthCheck, settings

    # CI profile (selected with --hypothesis-profile=ci): fewer examples,
    # no deadline — jit compiles inside property bodies blow any per-case
    # deadline, and the tier-1 job must stay under its 45-minute budget as
    # the property suites (isax, search, durability) grow. Local runs keep
    # the hypothesis default profile.
    settings.register_profile(
        "ci",
        max_examples=20,
        deadline=None,
        suppress_health_check=[HealthCheck.too_slow],
    )
except ImportError:  # hypothesis is optional, like in the test modules
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card; skips inside its fixture when "
        "torch.cuda.is_available() is False")


@pytest.fixture(scope="session")
def walk_20k():
    from repro.core import datagen
    return datagen.random_walk(20000, 256, seed=11)


@pytest.fixture(scope="session")
def small_index(walk_20k):
    import jax.numpy as jnp
    from repro.core import build_index
    return build_index(jnp.asarray(walk_20k))
