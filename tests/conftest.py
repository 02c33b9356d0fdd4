"""Test configuration: run the suite on an 8-device virtual CPU mesh.

The suite pins JAX to the CPU before any backend is initialized (XLA_FLAGS
must be set before the first backend initialization too). Tests marked
``gpu`` need an NVIDIA GPU: they skip here, and on a machine with the card
``PYPIC_TEST_GPU=1 python -m pytest -m gpu tests/`` runs them on it.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

if os.environ.get("PYPIC_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
# Allow float64 ground-truth comparisons in kernel unit tests; engine states
# pick their dtype explicitly (float32 by default) so this doesn't change
# engine behavior.
jax.config.update("jax_enable_x64", True)


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound in-process compiled-executable accumulation: a full-suite run
    deterministically SEGFAULTS inside XLA:CPU's backend_compile_and_load
    when compiling the fused dp-sheath shard_map program after ~250 prior
    compilations (reproduced 3x at the same site, RSS only ~5 GB of
    128 GB — compiler-state-dependent, not OOM; the same test passes in
    any shorter run). Clearing jit caches at module boundaries keeps the
    executable population small; cross-module program reuse is minimal so
    the recompile cost is a few percent."""
    yield
    import jax

    jax.clear_caches()


@pytest.fixture
def require_gpu():
    """Skip unless JAX's first device is a GPU (decided when the test runs,
    never at import or collection, so every worker collects the same
    tests)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run PYPIC_TEST_GPU=1 python -m "
                    "pytest -m gpu tests/ on the card")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (multi-step equivalence sweeps, "
        "multi-process bootstraps) — excluded from the fast lane: "
        "pytest -m 'not slow'",
    )
    config.addinivalue_line(
        "markers",
        "gpu: runs on an NVIDIA GPU only (skips elsewhere; see the "
        "require_gpu fixture)",
    )


def pytest_collection_modifyitems(config, items):
    """Apply the slow marker from tests/slow_tests.txt (measured: every
    family with a >= 2 s case on this 1-core box; nearly all suite time is
    compile-heavy integration tests, so the fast lane is the sub-2 s
    kernel/unit tier — ~2 min vs ~24 min full). Regenerate after large
    suite changes:
      pytest tests/ -q --durations=0 > /tmp/d.log
      grep -E '^[0-9.]+s call' /tmp/d.log | awk '$1+0 >= 2.0 {print $3}' \
        | sed 's/\\[.*//' | sort -u > tests/slow_tests.txt
    Unknown names are ignored, so renames degrade to 'not marked', never
    to collection errors."""
    import pathlib

    listed = pathlib.Path(__file__).with_name("slow_tests.txt")
    if not listed.exists():
        return
    slow = set(listed.read_text().split())
    import pytest as _pytest

    for item in items:
        base = item.nodeid.split("[")[0]
        if base in slow:
            item.add_marker(_pytest.mark.slow)
