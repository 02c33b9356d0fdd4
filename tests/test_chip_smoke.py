"""chip_smoke.py off the card: it refuses a CPU, fails without the repo,
and its phase functions run at tiny sizes (the Triton pass in the Pallas
interpreter)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _last_line_is_result(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    if not lines:
        return False
    try:
        return json.loads(lines[-1]).get("ok") is True
    except ValueError:
        return False


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """On a CPU-only machine, and in a directory holding nothing of the
    repo but the script, it exits non-zero and prints no result."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not _last_line_is_result(out.stdout)


def test_bench_exits_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for flags in ([], ["--only", "headline", "--particles", "1024"]):
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "bench.py")] + flags,
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert "GPU" in out.stderr
        assert not out.stdout.strip()


def test_phase_device():
    import chip_smoke

    info = chip_smoke.phase_device(require_gpu=False)
    assert info == {"platform": "cpu", "kind": "cpu", "count": 8}
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.phase_device()


def test_phase_kernel_tiny():
    import chip_smoke

    errs = chip_smoke.phase_kernel(3000, ngs=(50, 800), interpret=True)
    assert set(errs) == {50, 800}
    for ng, per in errs.items():
        assert set(per) == {"xla vs f64", "triton vs f64", "triton vs xla"}


def test_phase_compile_headline_and_timing_tiny():
    import chip_smoke

    cfg, state = chip_smoke.phase_compile(8192, 64, impl="xla")
    assert state.p.shape == (8192,) and cfg.maxiter == 4
    ms, iters, de = chip_smoke.phase_headline(8192, 4, impl="xla")
    assert ms > 0 and iters == 4.0 and abs(de) < chip_smoke.ENERGY_BOUND
    times = chip_smoke.phase_timing(4096, 2, order=("xla", "xla"))
    assert set(times) == {"xla", "xla+matmul"} and len(times["xla"]) == 2


def test_phase_main_path_tiny(tmp_path):
    import numpy as np

    import chip_smoke

    rate = chip_smoke.landau_cli(2000, 60, outdir=str(tmp_path))
    assert np.isfinite(rate) and rate < 0  # the envelope damps
    chip_smoke.phase_presets(("explicit_landau", "sheath_dd"), steps=2,
                             outdir=str(tmp_path))
    assert (tmp_path / "sheath_dd" / "metrics.npz").exists()


def test_phase_four_tiny(tmp_path):
    """The four-device phase on the virtual CPU mesh: 4 shards agree with
    1, no particle is dropped, and the other slab presets run."""
    import chip_smoke

    chip_smoke.phase_four(20_000, steps=3, cli_steps=2, outdir=str(tmp_path))
    assert (tmp_path / "pic_iead_dd" / "metrics.npz").exists()
