"""Multi-device tests on the 8-device virtual CPU mesh (conftest sets
--xla_force_host_platform_device_count=8)."""

import numpy as np
import jax
import pytest

from pypic_tpu.constants import E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON
from pypic_tpu.grid import GridSpec
from pypic_tpu import initialize as init
from pypic_tpu.engines import implicit
from pypic_tpu.parallel import make_mesh, make_data_parallel_step, shard_state
from pypic_tpu.runner import run


@pytest.fixture(scope="module")
def problem():
    density = 1e10
    te = 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(64, 15.0 * debye, "periodic")
    x, v, params = init.initialize_periodic(
        "two-stream", 16_000, density, 1, 0.05, grid, te, te, seed=2
    )
    return grid, x, v, params


def test_eight_devices_available():
    assert len(jax.devices()) >= 8


def test_data_parallel_matches_single_device(problem):
    grid, x, v, params = problem
    dt = 0.1 / params.wp

    cfg1 = implicit.ImplicitConfig(
        grid, dt, params.p2c, tol=1e-6, maxiter=40, backend="composed"
    )
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg1)
    _, m1 = run(implicit.make_step(cfg1), st, 50)

    mesh = make_mesh(8)
    cfg8 = implicit.ImplicitConfig(
        grid, dt, params.p2c, tol=1e-6, maxiter=40,
        backend="composed", axis_name="particles",
    )
    st8 = shard_state(st, mesh)
    step8 = make_data_parallel_step(
        implicit.make_step, cfg8, mesh, example_state=st
    )
    # the factory must hand back a COMPILED callable: a bare shard_map
    # dispatches eagerly op-by-op per shard when called outside jit
    # (~1000x on this mesh; regression of the round-3 fix)
    assert hasattr(step8, "lower"), "parallel step factory must jit"
    _, m8 = run(step8, st8, 50)

    ee1 = np.asarray(m1.field_energy, np.float64)
    ee8 = np.asarray(m8.field_energy, np.float64)
    np.testing.assert_allclose(ee8, ee1, rtol=1e-4)
    ke1 = np.asarray(m1.kinetic_energy, np.float64)
    ke8 = np.asarray(m8.kinetic_energy, np.float64)
    np.testing.assert_allclose(ke8, ke1, rtol=1e-5)
    # tracer particle lives in shard 0 and matches the single-device run
    np.testing.assert_allclose(
        np.asarray(m8.tracer_x), np.asarray(m1.tracer_x), rtol=1e-3
    )


def test_data_parallel_fused_backend(problem):
    """The fused Pallas backend under data-parallel sharding: each shard's
    kernel deposit is psum-reduced before the Ampere advance
    (engines.implicit step_fused _allreduce). Matches the single-device
    fused run to f32 reduction-order tolerance with the same Picard
    envelope — previously only the composed backend was exercised."""
    grid, x, v, params = problem
    dt = 0.1 / params.wp

    cfg1 = implicit.ImplicitConfig(
        grid, dt, params.p2c, tol=1e-6, maxiter=40, backend="fused"
    )
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg1)
    _, m1 = run(implicit.make_step(cfg1), st, 50)

    mesh = make_mesh(8)
    cfg8 = implicit.ImplicitConfig(
        grid, dt, params.p2c, tol=1e-6, maxiter=40,
        backend="fused", axis_name="particles",
    )
    st8 = shard_state(st, mesh)
    step8 = make_data_parallel_step(
        implicit.make_step, cfg8, mesh, example_state=st
    )
    _, m8 = run(step8, st8, 50)

    ee1 = np.asarray(m1.field_energy, np.float64)
    ee8 = np.asarray(m8.field_energy, np.float64)
    np.testing.assert_allclose(ee8, ee1, rtol=1e-4)
    ke1 = np.asarray(m1.kinetic_energy, np.float64)
    ke8 = np.asarray(m8.kinetic_energy, np.float64)
    np.testing.assert_allclose(ke8, ke1, rtol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(m8.picard_iters), np.asarray(m1.picard_iters)
    )


def test_graft_entry_contract():
    import __graft_entry__ as ge

    fn, example_args = ge.entry()
    new_state, metrics = jax.jit(fn)(*example_args)
    assert np.isfinite(float(metrics.field_energy))

    ge.dryrun_multichip(8)


def test_dryrun_multichip_fresh_process():
    """Regression for MULTICHIP_r01.json: the driver invokes the entry in a
    fresh process with NO XLA_FLAGS and only the real backend visible —
    dryrun_multichip must self-configure the virtual device mesh rather than
    rely on conftest's environment."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as ge; ge.dryrun_multichip(8); print('OK')"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK" in proc.stdout


def test_maybe_initialize_distributed_noop_without_env():
    from pypic_tpu.parallel.mesh import maybe_initialize_distributed

    assert maybe_initialize_distributed() is False


def test_maybe_initialize_distributed_single_process():
    """Env-gated jax.distributed bootstrap actually initializes a (1-process)
    distributed runtime in a fresh subprocess — the multi-host entry point
    (SURVEY.md §5). Real cross-process collectives are exercised by the
    two test_multiprocess_* tests below (2 OS processes, Gloo)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYPIC_COORDINATOR="localhost:12357",
               PYPIC_NUM_PROCESSES="1", PYPIC_PROCESS_ID="0")
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from pypic_tpu.parallel.mesh import maybe_initialize_distributed;"
        "assert maybe_initialize_distributed() is True;"
        "assert jax.process_count() == 1;"
        "assert maybe_initialize_distributed() is True;"  # idempotent
        "from pypic_tpu.parallel.mesh import make_mesh;"
        "m = make_mesh(1); print('DIST OK')"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=repo, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "DIST OK" in res.stdout


def _free_port():
    """OS-assigned free TCP port for a jax.distributed coordinator (the
    hardcoded-port form collides across concurrent/stale suite runs)."""
    import socket

    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def test_multiprocess_data_parallel_two_processes():
    """REAL multi-process validation (round 3c; closes the round-2 'multi-
    host unproven' flag as far as one machine allows): two OS processes,
    each contributing 4 virtual CPU devices, bootstrap through
    maybe_initialize_distributed into one 8-device global mesh and run the
    data-parallel implicit engine with cross-process Gloo collectives. Each
    process asserts the sharded metrics match its own single-device run."""
    import os
    import subprocess
    import sys
    import textwrap

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = textwrap.dedent("""
        import os, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax
        jax.config.update("jax_platforms", "cpu")
        pid = int(sys.argv[1])
        os.environ["PYPIC_COORDINATOR"] = "localhost:%PORT%"
        os.environ["PYPIC_NUM_PROCESSES"] = "2"
        os.environ["PYPIC_PROCESS_ID"] = str(pid)
        from pypic_tpu.parallel.mesh import (
            maybe_initialize_distributed, make_mesh)
        assert maybe_initialize_distributed() is True
        assert jax.process_count() == 2, jax.process_count()
        assert len(jax.devices()) == 8 and len(jax.local_devices()) == 4

        import dataclasses as dc
        import numpy as np
        import jax.numpy as jnp
        from pypic_tpu import GridSpec, constants as c, initialize
        from pypic_tpu.engines import implicit
        from pypic_tpu.parallel import make_data_parallel_step
        from pypic_tpu.parallel.dataparallel import shard_state
        from pypic_tpu.runner import run

        density, te = 1e10, 0.1 * 11600.0
        debye = np.sqrt(c.K_BOLTZMANN * te * c.EPSILON_0
                        / c.E_CHARGE**2 / density)
        grid = GridSpec(32, 15.0 * debye, "periodic")
        x, v, p = initialize.initialize_periodic(
            "two-stream", 4096, density, 1, 0.05, grid, te, te, seed=2)
        cfg = implicit.ImplicitConfig(grid, 0.1 / p.wp, p.p2c,
                                      tol=1e-8, maxiter=20,
                                      backend="composed")
        st = implicit.init_state(x, v, -c.E_CHARGE, c.M_ELECTRON, cfg)
        # single-device truth, computed independently in this process
        _, m1 = run(implicit.make_step(cfg), st, 5)

        mesh = make_mesh(8)  # global: 2 processes x 4 local devices
        cfg8 = dc.replace(cfg, axis_name="particles")
        step8 = make_data_parallel_step(
            implicit.make_step, cfg8, mesh, example_state=st)
        st8 = shard_state(st, mesh)
        _, m8 = run(step8, st8, 5)
        f1 = np.asarray(m1.field_energy, np.float64)
        f8 = np.asarray(jax.device_get(
            m8.field_energy.addressable_data(0)), np.float64)
        np.testing.assert_allclose(f8, f1, rtol=1e-4)
        k1 = np.asarray(m1.kinetic_energy, np.float64)
        k8 = np.asarray(jax.device_get(
            m8.kinetic_energy.addressable_data(0)), np.float64)
        np.testing.assert_allclose(k8, k1, rtol=1e-4)
        print(pid, "MULTIPROC OK", flush=True)
    """).replace("%PORT%", str(_free_port()))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    ps = [subprocess.Popen([sys.executable, "-c", prog, str(i)],
                           cwd=repo, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT) for i in range(2)]
    outs = []
    for i, p in enumerate(ps):
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode())
        assert p.returncode == 0, f"proc {i}:\n{outs[-1][-3000:]}"
    assert all("MULTIPROC OK" in o for o in outs)


def test_multiprocess_domain_decomposed_two_processes():
    """Two-process spatial domain decomposition: slab halo exchange
    (ppermute) and particle migration (gathered buckets) cross the PROCESS
    boundary over Gloo — the strongest multi-host validation one machine
    supports. Metrics must match a single-device run computed
    independently in each process, with migration active and drop-free."""
    import os
    import subprocess
    import sys
    import textwrap

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = textwrap.dedent("""
        import os, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax
        jax.config.update("jax_platforms", "cpu")
        pid = int(sys.argv[1])
        os.environ["PYPIC_COORDINATOR"] = "localhost:%PORT%"
        os.environ["PYPIC_NUM_PROCESSES"] = "2"
        os.environ["PYPIC_PROCESS_ID"] = str(pid)
        from pypic_tpu.parallel.mesh import (
            maybe_initialize_distributed, make_mesh)
        assert maybe_initialize_distributed() is True
        assert len(jax.devices()) == 8 and len(jax.local_devices()) == 4

        import numpy as np
        from pypic_tpu import GridSpec, constants as c, initialize
        from pypic_tpu.engines import explicit
        from pypic_tpu.parallel import domain
        from pypic_tpu.runner import run

        density, te = 1e10, 0.1 * 11600.0
        debye = np.sqrt(c.K_BOLTZMANN * te * c.EPSILON_0
                        / c.E_CHARGE**2 / density)
        grid = GridSpec(64, 15.0 * debye, "periodic")
        x, v, params = initialize.initialize_periodic(
            "two-stream", 8000, density, 1, 0.05, grid, te, te, seed=2)
        dt = 0.1 / params.wp
        ecfg = explicit.ExplicitConfig(grid, dt, params.p2c)
        est = explicit.init_state(x, v, -c.E_CHARGE, c.M_ELECTRON, ecfg)
        _, m1 = run(explicit.make_step(ecfg), est, 30)

        mesh = make_mesh(8, axis="slabs")
        dcfg = domain.DomainConfig(grid, dt, params.p2c, num_shards=8,
                                   migrate_cap=1024)
        dst = domain.shard_state(
            domain.init_state(x, v, -c.E_CHARGE, M := c.M_ELECTRON, dcfg),
            mesh, dcfg)
        _, m8 = run(domain.make_step(dcfg, mesh), dst, 30)

        def fetch(a):
            return np.asarray(jax.device_get(a.addressable_data(0)),
                              np.float64)

        np.testing.assert_allclose(fetch(m8.field_energy),
                                   np.asarray(m1.field_energy, np.float64),
                                   rtol=1e-4)
        alive = fetch(m8.n_alive)
        assert (alive == 8000).all(), alive
        assert fetch(m8.n_migrated).sum() > 0
        assert fetch(m8.n_dropped).sum() == 0

        # migration-amortized superstep across the same process boundary:
        # k=2 micro-steps per migrate, deposit halo covering the excursion
        import dataclasses as dc
        scfg = dc.replace(dcfg, halo=4)
        sup = jax.jit(domain.make_superstep(scfg, mesh, 2))
        st_s, fes = dst, []
        for _ in range(15):
            st_s, ms = sup(st_s)
            fes.append(fetch(ms.field_energy))
            assert fetch(ms.n_halo_clamped).sum() == 0
        np.testing.assert_allclose(
            np.concatenate(fes), np.asarray(m1.field_energy, np.float64),
            rtol=1e-4)
        print(pid, "DOMAIN MULTIPROC OK", flush=True)
    """).replace("%PORT%", str(_free_port()))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    ps = [subprocess.Popen([sys.executable, "-c", prog, str(i)],
                           cwd=repo, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT) for i in range(2)]
    outs = []
    for i, p in enumerate(ps):
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode())
        assert p.returncode == 0, f"proc {i}:\n{outs[-1][-3000:]}"
    assert all("DOMAIN MULTIPROC OK" in o for o in outs)


def test_multiprocess_cli_domain_preset():
    """The CLI's env-gated multi-host bootstrap drives the slab-sharded
    flagship preset across 2 OS processes end-to-end (global 8-device mesh,
    metrics written per process) — the run_pypic_dd.py driver surface at
    multi-host scale."""
    import os
    import subprocess
    import sys
    import textwrap

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = textwrap.dedent("""
        import os, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax
        jax.config.update("jax_platforms", "cpu")
        pid = int(sys.argv[1])
        os.environ["PYPIC_COORDINATOR"] = "localhost:%PORT%"
        os.environ["PYPIC_NUM_PROCESSES"] = "2"
        os.environ["PYPIC_PROCESS_ID"] = str(pid)
        sys.argv = ["cli", "run", "domain_implicit", "--particles", "20000",
                    "--steps", "3", "--outdir", f"/tmp/mp_cli_test_{pid}",
                    "--clean"]
        from pypic_tpu.cli import main
        main()
        import numpy as np
        m = np.load(f"/tmp/mp_cli_test_{pid}/metrics.npz")
        assert np.isfinite(m["field_energy"]).all()
        print(pid, "CLI MULTIPROC OK", flush=True)
    """).replace("%PORT%", str(_free_port()))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    ps = [subprocess.Popen([sys.executable, "-c", prog, str(i)],
                           cwd=repo, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT) for i in range(2)]
    outs = []
    for i, p in enumerate(ps):
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode())
        assert p.returncode == 0, f"proc {i}:\n{outs[-1][-3000:]}"
    assert all("CLI MULTIPROC OK" in o for o in outs)


def test_explicit_data_parallel_matches_single_device(problem):
    """Data-parallel explicit engine (completing the dp x engine matrix):
    per-shard rho deposits psum before the replicated Poisson solve so the
    carried rho/e stay global."""
    import dataclasses as dc

    from pypic_tpu.constants import E_CHARGE, M_ELECTRON
    from pypic_tpu.engines import explicit

    grid, x, v, params = problem
    dt = 0.1 / params.wp
    cfg1 = explicit.ExplicitConfig(grid, dt, params.p2c)
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg1)
    _, m1 = run(explicit.make_step(cfg1), st, 50)

    mesh = make_mesh(8)
    cfg8 = dc.replace(cfg1, axis_name="particles")
    step8 = make_data_parallel_step(
        explicit.make_step, cfg8, mesh, example_state=st)
    _, m8 = run(step8, shard_state(st, mesh), 50)

    ee1 = np.asarray(m1.field_energy, np.float64)
    ee8 = np.asarray(m8.field_energy, np.float64)
    np.testing.assert_allclose(ee8, ee1, rtol=1e-4)
    ke1 = np.asarray(m1.kinetic_energy, np.float64)
    ke8 = np.asarray(m8.kinetic_energy, np.float64)
    np.testing.assert_allclose(ke8, ke1, rtol=1e-5)
