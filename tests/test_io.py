"""Presets, CLI, diagnostics, and visualization round-trips."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pypic_tpu import diagnostics, presets, viz
from pypic_tpu.runner import run


def test_all_presets_construct_small():
    small = {
        "landau_damping": dict(n=2000),
        "two_stream": dict(n=2000),
        "bump_on_tail": dict(n=2000),
        "explicit_landau": dict(n=2000),
        "sheath_dd": dict(n=2000),
        "pic_iead": dict(n_per_species=100, ng=100),
        "pic_iead_gc": dict(n_per_species=100, ng=100),
        "pic_bca_aps": dict(ppc=2),
        "dirichlet_neumann_test": dict(n=2000, ng=100),
        "domain_implicit": dict(n=2000, shards=8),
        "pic_iead_dd": dict(n_per_species=100, ng=104, shards=8),
    }
    for name, kw in small.items():
        pre = presets.get(name, **kw)
        assert pre.name == name
        step = pre.make_step()
        new_state, metrics = step(pre.state)  # one step traces + runs
        assert new_state.p.shape == pre.state.p.shape


def test_preset_unknown():
    with pytest.raises(KeyError):
        presets.get("nope")


def test_cli_domain_magnetized_preset_end_to_end(tmp_path):
    """The slab-sharded magnetized engine is drivable through the CLI:
    metrics files, checkpoints, and resume on the 8-device virtual mesh."""
    outdir = str(tmp_path / "plots")
    pre = (
        "import os; os.environ['XLA_FLAGS']="
        "os.environ.get('XLA_FLAGS','')"
        "+' --xla_force_host_platform_device_count=8';"
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from pypic_tpu.cli import main;"
    )
    code = pre + (
        f"main(['run','pic_iead_dd','--steps','12',"
        f"'--outdir',r'{outdir}','--checkpoint-every','6','--clean',"
        f"'--plot'])"
    )
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=cwd)
    assert res.returncode == 0, res.stderr[-2000:]
    for f in ("time.out", "metrics.npz", "metrics.jsonl"):
        assert os.path.exists(os.path.join(outdir, f)), f
    # --plot on the slab-sharded state: IEAD heatmap written; the BCA
    # dashboard (which needs the iead_out leaf the domain state doesn't
    # carry) is skipped rather than crashing (round-4 review fix)
    assert os.path.getsize(os.path.join(outdir, "iead.png")) > 1000
    assert not os.path.exists(os.path.join(outdir, "bca_dashboard.png"))
    rows = [json.loads(l) for l in open(os.path.join(outdir, "metrics.jsonl"))]
    assert len(rows) == 12
    assert all(np.isfinite(r["phi_max"]) for r in rows)
    assert rows[-1]["n_dropped"] == 0
    ck = os.path.join(outdir, "checkpoints", "state_0000000012.npz")
    assert os.path.exists(ck)
    code2 = pre + (
        f"main(['run','pic_iead_dd','--steps','6',"
        f"'--outdir',r'{outdir}','--checkpoint-every','6','--resume'])"
    )
    res2 = subprocess.run([sys.executable, "-c", code2], capture_output=True,
                          text=True, cwd=cwd)
    assert res2.returncode == 0, res2.stderr[-2000:]
    assert "resumed from step 12" in res2.stderr
    rows2 = [json.loads(l) for l in open(os.path.join(outdir, "metrics.jsonl"))]
    assert len(rows2) == 6 and np.isfinite(rows2[-1]["phi_max"])


def test_first_peak_index():
    t = np.linspace(0, 10, 200)
    series = np.exp(-0.3 * t) * (np.sin(3 * t) ** 2 + 1e-3)
    idx = diagnostics.first_peak_index(series, t[1] - t[0])
    assert 0 < idx < 40
    # lands on (or adjacent to, from the centered derivative) the first peak
    assert series[idx] >= 0.95 * series[max(idx - 2, 0) : idx + 3].max()


def test_growth_and_damping_rate_fits():
    dt = 0.01
    t = np.arange(400) * dt
    gamma = 2.5
    grow = 1e-6 * np.exp(2 * gamma * t)
    grow = np.minimum(grow, 1e-3)  # saturate
    est = diagnostics.growth_rate_from_energy(grow, dt)
    assert abs(est - gamma) / gamma < 0.05

    damp = 1e-3 * np.exp(-2 * 1.5 * t) * (np.cos(20 * t) ** 2 + 1e-4)
    est2 = diagnostics.damping_rate_from_peaks(damp + 1e-12, dt, t_max=2.0)
    assert abs(est2 + 1.5) / 1.5 < 0.1


def test_write_run_outputs(tmp_path):
    d = str(tmp_path)
    diagnostics.write_run_outputs(
        d, np.arange(5.0), np.arange(3.0), {"wp": 1.0, "dt": 2.0}
    )
    assert np.loadtxt(os.path.join(d, "E2.txt")).shape == (5,)
    text = open(os.path.join(d, "parameters.out")).read()
    assert "wp 1.0" in text and "dt 2.0" in text


def test_viz_figures_and_gif(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1.0, 500)
    v = rng.normal(0, 1.0, 500)
    p = viz.summary_figure(
        str(tmp_path / "sum.png"), x, v, 1.0, np.exp(np.arange(10.0)),
        np.arange(10.0), 1.0, 0.5, rng.normal(size=32), rng.normal(size=32),
        1.0,
    )
    assert os.path.getsize(p) > 1000

    viz.sheath_figure(
        str(tmp_path / "sheath.png"), x, v, np.full(500, 1e-27),
        np.where(np.arange(500) < 250, 1, 2), rng.normal(size=32),
        rng.normal(size=32), rng.normal(size=32), 1.0,
    )

    # frames -> gif (convert.py parity)
    def frame(i, path):
        viz.summary_figure(
            path, x, v + i * 0.1, 1.0, np.exp(np.arange(10.0)),
            np.arange(10.0), 1.0, None, rng.normal(size=32),
            rng.normal(size=32), 1.0,
        )

    viz.save_frames(str(tmp_path), "ps", frame, [0, 2, 4])
    out = viz.convert(str(tmp_path), "ps", 0, 6, 2, str(tmp_path / "out.gif"))
    assert os.path.getsize(out) > 1000


def test_phase_space_replay(tmp_path):
    rng = np.random.default_rng(1)
    xs = rng.uniform(0, 1, (4, 200))
    vs = rng.normal(0, 1, (4, 200))
    out = viz.phase_space_replay(str(tmp_path / "replay.gif"), xs, vs)
    assert os.path.getsize(out) > 1000


def test_cli_end_to_end(tmp_path):
    """Drive the CLI as a subprocess — the run-script surface
    (run_pypic.py parity)."""
    outdir = str(tmp_path / "plots")
    env = dict(os.environ)
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from pypic_tpu.cli import main;"
        f"main(['run','two_stream','--steps','40','--particles','4000',"
        f"'--outdir',r'{outdir}','--plot','--plot-every','10',"
        f"'--checkpoint-every','20','--clean'])"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert res.returncode == 0, res.stderr[-2000:]
    for f in ("time.out", "E2.txt", "metrics.npz", "metrics.jsonl", "summary.png"):
        assert os.path.exists(os.path.join(outdir, f)), f
    rows = [json.loads(line) for line in open(os.path.join(outdir, "metrics.jsonl"))]
    assert len(rows) == 40  # scalar metrics stay full-cadence under thinning
    assert os.path.exists(os.path.join(outdir, "checkpoints", "state_0000000020.npz"))


def test_bench_contract(tmp_path):
    """bench.py prints exactly one JSON line with the driver's schema —
    since round 4 the default carries the whole matrix under "rows"
    (--budget-s 0 keeps this contract check to the headline + skip list;
    test_bench_smoke.py covers the full combined artifact)."""
    code = (
        "import sys; sys.argv=['bench.py','--cpu','--particles','20000',"
        "'--steps','2','--budget-s','0'];"
        "import runpy; runpy.run_path('bench.py', run_name='__main__')"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [l for l in res.stdout.strip().splitlines() if l.strip()]
    assert len(lines) == 1, res.stdout
    row = json.loads(lines[0])
    # round-5 schema: the accuracy clause (budget-skipped here, never
    # silently absent) + the vs_prior regression ratio ride the line
    assert set(row) == {"metric", "value", "unit", "vs_baseline",
                        "rows", "skipped", "drift_per_1e4", "vs_prior"}
    assert row["value"] > 0 and row["vs_baseline"] == row["value"] / 1e9
    assert row["drift_per_1e4"].startswith("skipped (budget")
    assert isinstance(row["vs_prior"], float)


def test_cli_particle_dump_and_bca_postprocess(tmp_path):
    """--dump-particles feeds the offline replay (pypic_vpython parity) and
    --bca-postprocess runs the pic_iead end-of-run surface budget."""
    outdir = str(tmp_path / "plots")
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from pypic_tpu.cli import main;"
        f"main(['run','pic_iead','--steps','30',"
        f"'--outdir',r'{outdir}','--clean',"
        f"'--dump-particles','100','--dump-every','10',"
        f"'--gif','--bca-postprocess'])"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert res.returncode == 0, res.stderr[-2000:]
    dump = os.path.join(outdir, "particle_output.txt")
    assert os.path.exists(dump)
    xs, vs = viz.load_particle_dump(dump, 100)
    assert xs.shape == (3, 100)  # 30 steps / dump-every 10
    out = viz.phase_space_replay(str(tmp_path / "replay.gif"), xs, vs)
    assert os.path.getsize(out) > 1000
    # --gif assembled the same replay in-run (run_pypic.py:19-21 parity)
    assert os.path.getsize(os.path.join(outdir, "phase_space.gif")) > 1000
    pp = os.path.join(outdir, "bca_postprocess.json")
    assert os.path.exists(pp)
    stats = json.load(open(pp))
    assert (stats["num_deposited_wall"] + stats["num_reflected_wall"]
            == stats["num_incident_wall"])


def test_cli_pic_iead_plot_figures(tmp_path):
    """--plot on the magnetized preset writes the IEAD heatmap and the BCA
    run dashboard — the offline equivalents of pic_iead's pcolormesh
    figures (pygcpic.py:1283-1298) and the pic_bca_aps 8-figure dashboard
    (pygcpic.py:1634-1702)."""
    outdir = str(tmp_path / "plots")
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from pypic_tpu.cli import main;"
        f"main(['run','pic_iead','--steps','10',"
        f"'--outdir',r'{outdir}','--clean','--plot'])"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert res.returncode == 0, res.stderr[-2000:]
    for name in ("iead.png", "bca_dashboard.png"):
        p = os.path.join(outdir, name)
        assert os.path.exists(p), f"{name} not written"
        assert os.path.getsize(p) > 1000


def test_run_thinned_keeps_scalars_full_cadence():
    """run_thinned thins only heavy array rows (the reference appends EE/KE
    every step and thins just plotting, pypic.py:570-579): scalar series stay
    usable for rate fits on thinned runs."""
    from pypic_tpu.constants import E_CHARGE, K_BOLTZMANN, M_ELECTRON, EPSILON_0
    from pypic_tpu.grid import GridSpec
    from pypic_tpu import initialize as init
    from pypic_tpu.engines import implicit
    from pypic_tpu.runner import run, run_thinned

    density, te = 1e10, 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(64, 15.0 * debye, "periodic")
    x, v, params = init.initialize_periodic(
        "two-stream", 4000, density, 1, 0.05, grid, te, te, seed=2
    )
    cfg = implicit.ImplicitConfig(grid, 0.1 / params.wp, params.p2c,
                                  tol=1e-6, maxiter=40)
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
    _, full = run(implicit.make_step(cfg), st, 40)
    _, thin = run_thinned(implicit.make_step(cfg), st, 40, 10)
    # scalars identical to the unthinned run at every step
    np.testing.assert_allclose(
        np.asarray(thin.field_energy), np.asarray(full.field_energy)
    )
    assert np.asarray(thin.field_energy).shape == (40,)


def test_run_thinned_heavy_rows_thinned():
    """Heavy (ng,) metric rows keep only every-k cadence."""
    from pypic_tpu.presets import pic_iead
    from pypic_tpu.runner import run_thinned

    pre = pic_iead(n_per_species=200)
    _, m = run_thinned(pre.make_step(), pre.state, 20, 5)
    assert np.asarray(m.phi).shape == (4, pre.config.grid.ng)
    assert np.asarray(m.n_active).shape == (20,)


def test_cli_domain_preset_end_to_end(tmp_path):
    """The flagship domain-decomposed config (BASELINE configs[4]) is
    drivable through the CLI like every other preset — metrics files,
    checkpoints, and bit-continuing resume on an 8-device virtual mesh."""
    outdir = str(tmp_path / "plots")
    pre = (
        "import os; os.environ['XLA_FLAGS']="
        "os.environ.get('XLA_FLAGS','')"
        "+' --xla_force_host_platform_device_count=8';"
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from pypic_tpu.cli import main;"
    )
    code = pre + (
        f"main(['run','domain_implicit','--steps','20',"
        f"'--particles','8192','--shards','8',"
        f"'--outdir',r'{outdir}','--checkpoint-every','10','--clean'])"
    )
    cwd = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=cwd)
    assert res.returncode == 0, res.stderr[-2000:]
    for f in ("time.out", "metrics.npz", "metrics.jsonl", "E2.txt"):
        assert os.path.exists(os.path.join(outdir, f)), f
    rows = [json.loads(l) for l in open(os.path.join(outdir, "metrics.jsonl"))]
    assert len(rows) == 20
    assert all(np.isfinite(r["field_energy"]) for r in rows)
    assert rows[-1]["n_dropped"] == 0
    ck = os.path.join(outdir, "checkpoints", "state_0000000020.npz")
    assert os.path.exists(ck)

    # resume from the step-20 checkpoint and run 10 more
    code2 = pre + (
        f"main(['run','domain_implicit','--steps','10',"
        f"'--particles','8192','--shards','8',"
        f"'--outdir',r'{outdir}','--checkpoint-every','10','--resume'])"
    )
    res2 = subprocess.run([sys.executable, "-c", code2], capture_output=True,
                          text=True, cwd=cwd)
    assert res2.returncode == 0, res2.stderr[-2000:]
    assert "resumed from step 20" in res2.stderr
    rows2 = [json.loads(l) for l in open(os.path.join(outdir, "metrics.jsonl"))]
    assert len(rows2) == 10 and np.isfinite(rows2[-1]["field_energy"])


def test_cli_domain_preset_migrate_every(tmp_path):
    """--migrate-every drives the migration-amortized superstep end-to-end:
    metrics flatten back to per-micro-step rows, checkpoint cadence stays in
    sim steps (rounded to a superstep boundary), and resume continues."""
    import sys

    from pypic_tpu.cli import main

    out = str(tmp_path / "clisup")
    argv_old = sys.argv
    try:
        sys.argv = ["cli", "run", "domain_implicit", "--particles", "8192",
                    "--steps", "12", "--migrate-every", "4", "--shards", "4",
                    "--outdir", out, "--checkpoint-every", "4", "--clean"]
        main()
    finally:
        sys.argv = argv_old
    rows = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
    assert len(rows) == 12
    assert all(np.isfinite(r["field_energy"]) for r in rows)
    assert rows[-1]["n_dropped"] == 0
    assert os.path.exists(
        os.path.join(out, "checkpoints", "state_0000000008.npz"))
    try:
        sys.argv = ["cli", "run", "domain_implicit", "--particles", "8192",
                    "--steps", "4", "--migrate-every", "4", "--shards", "4",
                    "--outdir", out, "--checkpoint-every", "4", "--resume"]
        main()
    finally:
        sys.argv = argv_old
    rows2 = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
    assert len(rows2) == 4 and np.isfinite(rows2[-1]["field_energy"])


def test_cli_domain_explicit_preset(tmp_path):
    """The explicit leapfrog cycle is drivable domain-decomposed from the
    CLI, per-step and as a migration-amortized superstep."""
    import sys

    from pypic_tpu.cli import main

    out = str(tmp_path / "clide")
    argv_old = sys.argv
    try:
        sys.argv = ["cli", "run", "domain_explicit", "--particles", "16000",
                    "--steps", "8", "--shards", "8", "--outdir", out,
                    "--clean"]
        main()
        sys.argv = ["cli", "run", "domain_explicit", "--particles", "16000",
                    "--steps", "8", "--migrate-every", "4", "--shards", "4",
                    "--outdir", out + "_sup", "--clean"]
        main()
        # --opt reaches preset keywords without a dedicated flag: the
        # distributed field solve end-to-end from the CLI
        sys.argv = ["cli", "run", "domain_explicit", "--particles", "16000",
                    "--steps", "8", "--shards", "4", "--opt",
                    "field_solve=distributed", "--outdir", out + "_dist",
                    "--clean"]
        main()
        # a strict-signature preset rejects unknown --opt keys cleanly
        # (the **kw presets swallow extras by design, like migrate_every)
        sys.argv = ["cli", "run", "explicit_landau", "--opt",
                    "not_a_kwarg=1", "--outdir", out, "--steps", "1"]
        with pytest.raises(SystemExit, match="--opt"):
            main()
        sys.argv = ["cli", "run", "explicit_landau", "--opt", "nosep",
                    "--outdir", out, "--steps", "1"]
        with pytest.raises(SystemExit, match="KEY=VALUE"):
            main()
    finally:
        sys.argv = argv_old
    for d in (out, out + "_sup", out + "_car"):
        rows = [json.loads(l) for l in open(os.path.join(d, "metrics.jsonl"))]
        assert len(rows) == 8
        assert all(np.isfinite(r["field_energy"]) for r in rows)
        assert rows[-1]["n_dropped"] == 0
    assert rows[-1]["n_halo_clamped"] == 0


def test_cli_domain_preset_2d_replicas(tmp_path):
    """--replicas composes the dp axis with the slab axis end-to-end from
    the CLI (2D slabs x dp mesh on the virtual 8-device backend)."""
    import sys

    from pypic_tpu.cli import main

    out = str(tmp_path / "cli2d")
    argv_old = sys.argv
    try:
        sys.argv = ["cli", "run", "domain_implicit", "--particles", "16000",
                    "--steps", "2", "--replicas", "2", "--outdir", out,
                    "--clean"]
        main()
    finally:
        sys.argv = argv_old
    m = np.load(os.path.join(out, "metrics.npz"))
    assert np.isfinite(m["field_energy"]).all()
