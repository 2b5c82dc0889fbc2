"""Shared fixtures.  NOTE: no XLA_FLAGS here on purpose — tests must see the
1 real CPU device; only the dry-run forces 512 placeholder devices (and the
distributed tests spawn subprocesses with their own flags).

Tests that need a real in-process mesh carry the ``distributed`` marker and
auto-skip below 8 devices; the dedicated CI job (and local runs of the
battery) provide them via

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        PYTHONPATH=src python -m pytest -m distributed
"""
import jax
import jax.numpy as jnp
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "distributed: needs >= 8 jax devices; run under "
        "XLA_FLAGS=--xla_force_host_platform_device_count=8 (auto-skipped "
        "otherwise)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (skipped without one); run on the card "
        "with PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py")


def pytest_collection_modifyitems(config, items):
    if jax.device_count() >= 8:
        return
    skip = pytest.mark.skip(
        reason="needs 8 devices; set "
               "XLA_FLAGS=--xla_force_host_platform_device_count=8")
    for item in items:
        if "distributed" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def mesh8():
    """Row-sharded 8-way mesh (the canonical distributed-test layout)."""
    from repro.launch.mesh import make_mesh
    return make_mesh((8,), ("data",))

try:                                  # hypothesis is a dev/CI requirement
    import os

    import hypothesis

    # CI runs the property suites under HYPOTHESIS_PROFILE=ci: fixed,
    # derandomized examples so per-PR runs are reproducible.  Hypothesis
    # does not read the env var on its own — load_profile is required.
    hypothesis.settings.register_profile(
        "ci", max_examples=40, deadline=None, derandomize=True)
    hypothesis.settings.register_profile(
        "dev", max_examples=10, deadline=None)
    hypothesis.settings.load_profile(
        os.environ.get("HYPOTHESIS_PROFILE", "dev"))
except ImportError:
    pass


@pytest.fixture(scope="module", autouse=True)
def _clear_jit_caches():
    """Drop compiled-executable caches between test modules.

    The suite compiles hundreds of distinct programs (kernel sweeps, ten
    architectures, trainer graphs); without this the CPU JIT's resident
    code pushes the host OOM near the end of a full run ("LLVM compilation
    error: Cannot allocate memory")."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def make_lowrank(key, m: int, n: int, rank: int, dtype=jnp.float32):
    """Synthetic fixed-rank matrix, the paper's test input (§6.1)."""
    k1, k2 = jax.random.split(key)
    M = jax.random.normal(k1, (m, rank), dtype)
    N = jax.random.normal(k2, (rank, n), dtype)
    return M @ N
