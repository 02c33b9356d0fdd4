"""The platform module's choices and the compile-cache placement."""

import os
import subprocess
import sys

import pytest

from pypic_tpu import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("plat,expect", [("cpu", "xla"), ("gpu", "triton"),
                                         ("unknown-accel", "xla")])
def test_picard_impl_auto(plat, expect):
    assert platform.picard_impl(10**8, "auto", platform=plat) == expect


def test_picard_impl_explicit_requests():
    assert platform.picard_impl(10, "xla", platform="gpu") == "xla"
    assert platform.picard_impl(10, "triton", platform="gpu") == "triton"
    for plat in ("cpu", "unknown-accel"):
        with pytest.raises(ValueError, match="needs an NVIDIA GPU"):
            platform.picard_impl(10, "triton", platform=plat)
    with pytest.raises(ValueError, match="unknown Picard"):
        platform.picard_impl(10, "mosaic", platform="gpu")
    # this suite runs on the CPU: the device decides
    assert platform.picard_impl(10) == "xla"


def test_deposit_and_tridiag_defaults():
    for plat in ("cpu", "gpu", "unknown-accel"):
        assert platform.deposit_method(10**8, 200, platform=plat) == "scatter"
        assert platform.tridiag_method(600, platform=plat) == "thomas"


def test_engine_rejects_triton_off_gpu():
    """An engine asked for the Triton pass on the CPU raises instead of
    running the interpreter."""
    import numpy as np

    from pypic_tpu.engines import implicit
    from pypic_tpu.grid import GridSpec

    grid = GridSpec(32, 32.0, "periodic")
    cfg = implicit.ImplicitConfig(grid, 0.1, 1.0, picard_impl="triton")
    x = np.linspace(0, 31, 64)
    st = implicit.init_state(x, np.zeros(64), -1.0, 1.0, cfg)
    with pytest.raises(ValueError, match="needs an NVIDIA GPU"):
        implicit.make_step(cfg)(st)


def _cache_dir(env):
    code = ("from pypic_tpu import platform; import jax; "
            "print(platform.compile_cache()); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


@pytest.mark.parametrize("set_env", [False, True])
def test_compile_cache_location(tmp_path, set_env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is the
    fixed <repo>/.jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if set_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
        expect = str(tmp_path / "cache")
    else:
        expect = os.path.join(REPO, ".jax_cache")
    used, configured = _cache_dir(env)
    assert used == expect
    assert configured == expect


def test_gpu_query_without_nvidia_smi(monkeypatch):
    monkeypatch.setattr(platform.shutil, "which", lambda name: None)
    assert platform.gpu_name_and_power_limit() is None
