"""Test configuration: run on a virtual 8-device CPU mesh so sharding tests
work without several cards, with deterministic seeds. Must set XLA flags
before jax initializes.

Tests run on the CPU unless JAX_PLATFORMS says otherwise; the `gpu`-marked
tests need a card and run with `JAX_PLATFORMS=cuda,cpu python -m pytest
tests -m gpu`."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def gpu():
    """The first GPU, or a skip. Decided when the test runs, never at
    import, so every worker collects the same tests."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu")
    return devices[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Work around an in-process jaxlib 0.9.0 CPU-backend crash: after many
    hundreds of compiled programs accumulate in one process, the NEXT
    interpret-mode Pallas compile segfaults inside XLA (each file passes
    in isolation). Dropping compiled-program caches at module boundaries
    keeps the per-process executable count bounded. Costs recompiles of
    the handful of programs shared across modules.

    The eval harnesses track which programs they already compiled+warmed
    (module-level _WARMED sets) so recompiles never land inside their
    timed regions — clearing the compiled caches without clearing those
    sets would silently put a recompile back into time_s/pairs_per_s."""
    jax.clear_caches()
    from psulvsb_tpu.eval import batch_harness, realdata

    batch_harness._WARMED.clear()
    realdata._WARMED.clear()
    yield
