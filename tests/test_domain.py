"""Domain decomposition: slab deposits + halo exchange + particle migration
match the single-device engine exactly (8-device virtual CPU mesh)."""

import numpy as np
import jax
import pytest

from pypic_tpu.constants import E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON
from pypic_tpu.grid import GridSpec
from pypic_tpu import initialize as init
from pypic_tpu.engines import explicit
from pypic_tpu.parallel import make_mesh, domain
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


def test_domain_matches_single_device(problem):
    grid, x, v, params = problem
    dt = 0.1 / params.wp

    ecfg = explicit.ExplicitConfig(grid, dt, params.p2c)
    est = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, ecfg)
    _, m1 = run(explicit.make_step(ecfg), est, 100)

    mesh = make_mesh(8, axis="slabs")
    dcfg = domain.DomainConfig(grid, dt, params.p2c, num_shards=8,
                               migrate_cap=2048)
    dst = domain.shard_state(
        domain.init_state(x, v, -E_CHARGE, M_ELECTRON, dcfg), mesh, dcfg
    )
    _, m8 = run(domain.make_step(dcfg, mesh), dst, 100)

    ee1 = np.asarray(m1.field_energy, np.float64)
    ee8 = np.asarray(m8.field_energy, np.float64)
    np.testing.assert_allclose(ee8, ee1, rtol=1e-4)
    ke1 = np.asarray(m1.kinetic_energy, np.float64)
    ke8 = np.asarray(m8.kinetic_energy, np.float64)
    np.testing.assert_allclose(ke8, ke1, rtol=1e-5)
    # no particles lost, migration active, no overflow
    assert (np.asarray(m8.n_alive) == 16_000).all()
    assert np.asarray(m8.n_migrated).sum() > 0
    assert np.asarray(m8.n_dropped).sum() == 0


def test_domain_overflow_detected(problem):
    """A too-small migration bucket is *reported*, not silent."""
    grid, x, v, params = problem
    dt = 0.1 / params.wp
    mesh = make_mesh(8, axis="slabs")
    dcfg = domain.DomainConfig(grid, dt, params.p2c, num_shards=8,
                               migrate_cap=8)  # absurdly small
    dst = domain.shard_state(
        domain.init_state(x, v, -E_CHARGE, M_ELECTRON, dcfg), mesh, dcfg
    )
    _, m = run(domain.make_step(dcfg, mesh), dst, 20)
    assert np.asarray(m.n_dropped).sum() > 0
    # dropped particles leave the population (conservation bookkeeping holds)
    n_alive = np.asarray(m.n_alive)
    assert n_alive[-1] == 16_000 - np.asarray(m.n_dropped).sum()


@pytest.mark.parametrize("field_solve", ["replicated", "distributed"])
def test_domain_explicit_superstep_k1_bitexact(problem, field_solve):
    """make_superstep(cfg, mesh, 1) IS make_step with a (1,)-stacked metrics
    axis: bit-identical particle state (the halo=0 clamped-deposit micro-step
    reduces to the per-step path when positions start on their owners)."""
    grid, x, v, params = problem
    dt = 0.1 / params.wp
    mesh = make_mesh(8, axis="slabs")
    dcfg = domain.DomainConfig(grid, dt, params.p2c, num_shards=8,
                               migrate_cap=2048, field_solve=field_solve)
    dst = domain.shard_state(
        domain.init_state(x, v, -E_CHARGE, M_ELECTRON, dcfg), mesh, dcfg
    )
    s1, m1 = jax.jit(domain.make_step(dcfg, mesh))(dst)
    s2, m2 = jax.jit(domain.make_superstep(dcfg, mesh, 1))(dst)
    np.testing.assert_array_equal(np.asarray(s1.p), np.asarray(s2.p))
    np.testing.assert_array_equal(np.asarray(s1.v), np.asarray(s2.v))
    np.testing.assert_array_equal(np.asarray(s1.alive), np.asarray(s2.alive))
    assert np.asarray(m2.field_energy).shape == (1,)
    assert float(m2.field_energy[0]) == float(m1.field_energy)
    assert int(m2.n_migrated[0]) == int(m1.n_migrated)
    assert int(m2.n_halo_clamped[0]) == 0


@pytest.mark.parametrize("field_solve", ["replicated", "distributed"])
def test_domain_explicit_superstep_matches_per_step(problem, field_solve):
    """k=4 superstep (migrate once per 4 micro-steps, deposits over the
    k-step halo) follows the per-step-migrate trajectories: energies to f32
    reduction-order tolerance, population conserved, zero halo clamps when
    the halo covers the excursion, migration counted only in last slots."""
    grid, x, v, params = problem
    dt = 0.1 / params.wp
    k = 4
    # 4 shards x 16-cell slabs; ~1.1 cells/step excursion -> halo 12 covers
    # 4 micro-steps of 8-sigma tails on this workload
    cfg1 = domain.DomainConfig(grid, dt, params.p2c, num_shards=4,
                               migrate_cap=4096, field_solve=field_solve)
    cfgk = domain.DomainConfig(grid, dt, params.p2c, num_shards=4,
                               migrate_cap=4096, halo=12,
                               field_solve=field_solve)
    mesh = make_mesh(4, axis="slabs")
    dst = domain.shard_state(
        domain.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg1), mesh, cfg1
    )
    _, m1 = run(domain.make_step(cfg1, mesh), dst, 2 * k)

    sup = jax.jit(domain.make_superstep(cfgk, mesh, k))
    s, chunks = dst, []
    for _ in range(2):
        s, m = sup(s)
        chunks.append(jax.tree.map(np.asarray, m))
    m2 = jax.tree.map(lambda *xs: np.concatenate(xs), *chunks)

    np.testing.assert_allclose(
        m2.field_energy, np.asarray(m1.field_energy, np.float64), rtol=1e-4
    )
    np.testing.assert_allclose(
        m2.kinetic_energy, np.asarray(m1.kinetic_energy, np.float64),
        rtol=1e-5,
    )
    assert (m2.n_alive == 16_000).all()
    assert m2.n_dropped.sum() == 0
    assert m2.n_halo_clamped.sum() == 0
    assert (m2.n_migrated[[0, 1, 2, 4, 5, 6]] == 0).all()
    assert m2.n_migrated[[3, 7]].sum() > 0
    assert int(np.asarray(s.step)) == 2 * k


def test_domain_explicit_superstep_clamp_detected(problem):
    """An undersized halo reports outrunners via n_halo_clamped instead of
    silently misdepositing."""
    grid, x, v, params = problem
    dt = 0.1 / params.wp
    mesh = make_mesh(4, axis="slabs")
    cfg = domain.DomainConfig(grid, dt, params.p2c, num_shards=4,
                              migrate_cap=4096, halo=1)
    dst = domain.shard_state(
        domain.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg), mesh, cfg
    )
    sup = jax.jit(domain.make_superstep(cfg, mesh, 8))
    _, m = sup(dst)
    assert np.asarray(m.n_halo_clamped).sum() > 0


def test_domain_init_rejects_bad_shard_count(problem):
    grid, x, v, params = problem
    with pytest.raises(ValueError, match="divisible"):
        domain.DomainConfig(grid, 1e-9, params.p2c, num_shards=7)


@pytest.mark.parametrize("num_shards", [1, 2])
def test_domain_small_shard_counts(problem, num_shards):
    """With 1 or 2 shards the left/right neighbours coincide (with the shard
    itself at D=1): migration predicates must stay exclusive or particles
    duplicate into both buckets (regression)."""
    grid, x, v, params = problem
    dt = 0.1 / params.wp
    mesh = make_mesh(num_shards, axis="slabs")
    dcfg = domain.DomainConfig(grid, dt, params.p2c, num_shards=num_shards,
                               migrate_cap=4096)
    dst = domain.shard_state(
        domain.init_state(x, v, -E_CHARGE, M_ELECTRON, dcfg), mesh, dcfg
    )
    _, m = run(domain.make_step(dcfg, mesh), dst, 20)
    assert (np.asarray(m.n_alive) == 16_000).all()
    assert np.asarray(m.n_dropped).sum() == 0


def test_migrate_multihop_routes_distant_particles():
    """A particle legitimately crossing several slabs in one step survives
    and lands on its owner shard (VERDICT round-1 weakness 3: previously
    counted in n_dropped and removed)."""
    from jax.sharding import PartitionSpec as P
    from jax import lax
    import jax.numpy as jnp

    d_tot, cap, ng = 8, 4, 64
    c = ng // d_tot
    mesh = make_mesh(d_tot, axis="slabs")

    # each shard sends one particle `i + 1` slabs away (hops of 1..4, some
    # multi-hop); the destination pattern is a permutation per i so slot
    # capacity is never exceeded and every drop would be a routing bug
    rng = np.random.default_rng(0)
    n_per = 4
    p = np.zeros((d_tot, n_per), np.float32)
    tags = np.zeros((d_tot, n_per), np.float32)
    for dd in range(d_tot):
        for i in range(n_per):
            dest = (dd + i + 1) % d_tot
            p[dd, i] = dest * c + rng.uniform(0, c)
            tags[dd, i] = dd * n_per + i
    alive = np.ones((d_tot, n_per), bool)

    def f(p, tags, alive):
        d = lax.axis_index("slabs")
        (p2, t2), alive2, n_mig, n_drop = domain.migrate(
            [p, tags], alive, d,
            ng=ng, cells_per_shard=c, num_shards=d_tot, cap=cap, ax="slabs",
        )
        owner_ok = jnp.where(
            alive2,
            (jnp.clip(jnp.floor(p2).astype(jnp.int32), 0, ng - 1) // c) == d,
            True,
        )
        return p2, t2, alive2, jnp.all(owner_ok), n_mig, n_drop

    shard = jax.shard_map(
        f, mesh=mesh,
        in_specs=(P("slabs"), P("slabs"), P("slabs")),
        out_specs=(P("slabs"), P("slabs"), P("slabs"), P(), P(), P()),
        check_vma=False,
    )
    p2, t2, alive2, owner_ok, n_mig, n_drop = shard(
        jnp.asarray(p.reshape(-1)), jnp.asarray(tags.reshape(-1)),
        jnp.asarray(alive.reshape(-1)),
    )
    assert int(n_drop) == 0
    assert bool(owner_ok)
    assert int(np.asarray(alive2).sum()) == d_tot * n_per
    # every tagged particle survived exactly once
    surviving = np.sort(np.asarray(t2)[np.asarray(alive2)])
    np.testing.assert_array_equal(surviving, np.arange(d_tot * n_per))
    assert int(n_mig) > 0


def test_domain_implicit_matches_single_device(problem):
    """8-shard slab-sharded CN-Picard == single-device composed implicit
    (VERDICT round-1 item 2): same Picard envelope, same trajectories to
    f32 reduction-order tolerance."""
    from pypic_tpu.engines import implicit
    from pypic_tpu.parallel import domain_implicit as di

    grid, x, v, params = problem
    dt = 0.1 / params.wp

    cfg1 = implicit.ImplicitConfig(
        grid, dt, params.p2c, tol=1e-6, maxiter=40, backend="composed"
    )
    st1 = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg1)
    _, m1 = run(implicit.make_step(cfg1), st1, 50)

    mesh = make_mesh(8, axis="slabs")
    cfg8 = di.DomainImplicitConfig(
        grid, dt, params.p2c, num_shards=8, tol=1e-6, maxiter=40,
        halo=4, migrate_cap=2048,
    )
    st8 = di.shard_state(
        di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg8), mesh, cfg8
    )
    _, m8 = run(di.make_step(cfg8, mesh), st8, 50)

    ee1 = np.asarray(m1.field_energy, np.float64)
    ee8 = np.asarray(m8.field_energy, np.float64)
    np.testing.assert_allclose(ee8, ee1, rtol=1e-4)
    ke1 = np.asarray(m1.kinetic_energy, np.float64)
    ke8 = np.asarray(m8.kinetic_energy, np.float64)
    np.testing.assert_allclose(ke8, ke1, rtol=1e-5)
    assert (np.asarray(m8.n_alive) == 16_000).all()
    assert np.asarray(m8.n_dropped).sum() == 0
    assert np.asarray(m8.n_halo_clamped).sum() == 0
    assert np.asarray(m8.n_migrated).sum() > 0
    # Picard converges in the same envelope
    np.testing.assert_array_equal(
        np.asarray(m8.picard_iters), np.asarray(m1.picard_iters)
    )


def test_domain_implicit_halo_clamp_counter(problem):
    """The in-kernel finalize statistics actually count halo excursions:
    with an undersized halo and fast particles the fused path reports a
    nonzero n_halo_clamped matching the composed backend's count on the
    same trajectories-within-tolerance run, and reports zero again once
    the halo covers the excursions."""
    from pypic_tpu.parallel import domain_implicit as di

    grid, x, v, params = problem
    mesh = make_mesh(8, axis="slabs")
    counts = {}
    # (backend, halo, dt_factor): large steps force multi-cell excursions
    for backend, halo, f_dt in (("fused", 1, 0.4), ("composed", 1, 0.4),
                                ("fused", 5, 0.1)):
        dt = f_dt / params.wp
        cfg = di.DomainImplicitConfig(
            grid, dt, params.p2c, num_shards=8, tol=1e-6, maxiter=40,
            halo=halo, migrate_cap=4096, backend=backend,
        )
        st = di.shard_state(
            di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg), mesh, cfg
        )
        _, m = run(di.make_step(cfg, mesh), st, 10)
        counts[(backend, halo)] = int(np.asarray(m.n_halo_clamped).sum())
        assert (np.asarray(m.n_alive) == 16_000).all()
    assert counts[("fused", 1)] > 0, "undersized halo must report clamps"
    # same workload, same undersized halo: the two backends count the same
    # excursions up to their (tolerance-level) trajectory differences
    f, c = counts[("fused", 1)], counts[("composed", 1)]
    assert abs(f - c) <= 0.2 * max(f, c), (f, c)
    assert counts[("fused", 5)] == 0, "generous halo must report none"


@pytest.mark.parametrize("backend", ["composed", "fused"])
def test_domain_implicit_2d_mesh_slabs_x_dp(problem, backend):
    """Composed parallelism on a 2D mesh — 4 spatial slabs x 2
    data-parallel replicas (8 devices): fields slab-sharded and replicated
    across replicas, slab deposits psum'd over the replica axis, migration
    riding the slab axis within each replica. Matches the single-device
    composed engine to f32 reduction-order tolerance and conserves the
    population. Both backends run (fused in interpret mode on CPU — the
    dpsum placement inside the fused Picard/finalize path must hold too)."""
    from pypic_tpu.engines import implicit
    from pypic_tpu.parallel import domain_implicit as di
    from pypic_tpu.parallel import make_mesh2

    grid, x, v, params = problem
    dt = 0.1 / params.wp

    cfg1 = implicit.ImplicitConfig(
        grid, dt, params.p2c, tol=1e-6, maxiter=40, backend="composed"
    )
    st1 = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg1)
    _, m1 = run(implicit.make_step(cfg1), st1, 50)

    mesh = make_mesh2(4, 2, axes=("slabs", "dp"))
    cfg = di.DomainImplicitConfig(
        grid, dt, params.p2c, num_shards=4, tol=1e-6, maxiter=40,
        halo=4, migrate_cap=2048, dp_axis_name="dp", num_replicas=2,
        backend=backend,
    )
    st = di.shard_state(
        di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg), mesh, cfg
    )
    _, m = run(di.make_step(cfg, mesh), st, 50)

    # the fused path finalizes from the converged field while the composed
    # baseline returns the last iterate — equal within the Picard
    # tolerance (see test_domain_implicit_fused_matches_composed)
    rt_ee, rt_ke = (1e-4, 1e-5) if backend == "composed" else (3e-3, 1e-4)
    ee1 = np.asarray(m1.field_energy, np.float64)
    ee = np.asarray(m.field_energy, np.float64)
    np.testing.assert_allclose(ee, ee1, rtol=rt_ee)
    ke1 = np.asarray(m1.kinetic_energy, np.float64)
    ke = np.asarray(m.kinetic_energy, np.float64)
    np.testing.assert_allclose(ke, ke1, rtol=rt_ke)
    assert (np.asarray(m.n_alive) == 16_000).all()
    assert np.asarray(m.n_dropped).sum() == 0
    assert np.asarray(m.n_migrated).sum() > 0
    np.testing.assert_array_equal(
        np.asarray(m.picard_iters), np.asarray(m1.picard_iters)
    )


def test_domain_sheath_floating_potential():
    """8-shard bounded sheath reproduces the single-device acceptance
    (tests/test_sheath.py::test_sheath_formation_wall_potential): walls
    charge several Te/e below the quasi-neutral core (VERDICT item 3)."""
    from pypic_tpu.constants import K_BOLTZMANN
    from pypic_tpu.parallel import domain_sheath as ds

    density = 1e19
    dt = 1e-12
    dx = 1e-5
    te = ti = 10.0 * 11600.0
    ng = 56  # divisible by 8 (reference uses 51, PIC_L_DD.py:325)
    n = 10_000
    length = dx * (ng - 1)
    grid = GridSpec(ng, length, "dirichlet-dirichlet")
    d = init.initialize_sheath(n, density, 1.0, 0.0, grid, te, ti, seed=3)
    p2c = length * density / n

    mesh = make_mesh(8, axis="slabs")
    cfg = ds.DomainSheathConfig(
        grid, dt, p2c,
        kbte=K_BOLTZMANN * te, kbti=K_BOLTZMANN * ti,
        num_shards=8, halo=2, migrate_cap=4096,
        exit_hist_vmax=3e6, record_exit_after_step=300,
    )
    st = ds.shard_state(
        ds.init_state(d["x"], d["v"], d["q"], d["m"], d["species"], cfg,
                      seed=1),
        mesh, cfg,
    )
    _, m = run(ds.make_step(cfg, mesh), st, 1500)

    assert np.asarray(m.n_dropped).sum() == 0
    n_act = np.asarray(m.n_active)
    lost = np.asarray(m.n_lost_left) + np.asarray(m.n_lost_right)
    np.testing.assert_array_equal(n_act + lost, n)
    assert np.asarray(m.n_migrated).sum() > 0

    phi = np.asarray(m.phi, np.float64)[-300:].mean(axis=0)
    te_volts = te * K_BOLTZMANN / E_CHARGE  # 10 V
    drop_l = phi[0] - phi.max()
    drop_r = phi[-1] - phi.max()
    assert drop_l < -0.5 * te_volts, f"left wall drop {drop_l}"
    assert drop_r < -0.5 * te_volts, f"right wall drop {drop_r}"
    assert drop_l > -4.0 * te_volts and drop_r > -4.0 * te_volts
    assert np.argmax(phi) not in (0, len(phi) - 1)


def test_domain_implicit_fused_matches_composed(problem):
    """The Pallas extended-slab fused backend == the composed op backend
    (interpret mode on CPU exercises the identical kernel code path)."""
    from pypic_tpu.parallel import domain_implicit as di

    grid, x, v, params = problem
    dt = 0.1 / params.wp
    mesh = make_mesh(8, axis="slabs")
    runs = {}
    for backend in ("composed", "fused"):
        cfg = di.DomainImplicitConfig(
            grid, dt, params.p2c, num_shards=8, tol=1e-6, maxiter=40,
            halo=4, migrate_cap=2048, backend=backend,
        )
        st = di.shard_state(
            di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg), mesh, cfg
        )
        runs[backend] = run(di.make_step(cfg, mesh), st, 30)[1]
    # the fused path finalizes from the converged field while composed
    # returns the last iterate (engines.implicit fused semantics) — equal
    # within the Picard tolerance, diverging slowly at f32
    ee_c = np.asarray(runs["composed"].field_energy, np.float64)
    ee_f = np.asarray(runs["fused"].field_energy, np.float64)
    np.testing.assert_allclose(ee_f, ee_c, rtol=3e-3)
    ke_c = np.asarray(runs["composed"].kinetic_energy, np.float64)
    ke_f = np.asarray(runs["fused"].kinetic_energy, np.float64)
    np.testing.assert_allclose(ke_f, ke_c, rtol=1e-4)
    assert np.asarray(runs["fused"].n_dropped).sum() == 0
    assert np.asarray(runs["fused"].n_halo_clamped).sum() == 0
    np.testing.assert_array_equal(
        np.asarray(runs["fused"].picard_iters),
        np.asarray(runs["composed"].picard_iters),
    )


@pytest.mark.parametrize("backend", ["composed", "fused"])
def test_domain_implicit_picard_accel_conserving_config(problem, backend):
    """The conserving configuration (fixed-4 + extrapolate + Anderson,
    PERF.md round 3) on the 8-shard domain engine matches the single-device
    implicit engine running the identical configuration: the secant inner
    products psum over the slab axis, so mixing the slab-sharded field is
    the same map as mixing the global one. Both domain backends run (fused
    in interpret mode on CPU)."""
    from pypic_tpu.engines import implicit
    from pypic_tpu.parallel import domain_implicit as di

    grid, x, v, params = problem
    dt = 0.1 / params.wp
    kw = dict(tol=1e-30, maxiter=4, picard_init="extrapolate",
              picard_accel="anderson")

    cfg1 = implicit.ImplicitConfig(grid, dt, params.p2c,
                                   backend="composed", **kw)
    st1 = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg1)
    _, m1 = run(implicit.make_step(cfg1), st1, 50)

    mesh = make_mesh(8, axis="slabs")
    cfg8 = di.DomainImplicitConfig(
        grid, dt, params.p2c, num_shards=8, halo=4, migrate_cap=2048,
        backend=backend, **kw,
    )
    st8 = di.shard_state(
        di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg8), mesh, cfg8
    )
    _, m8 = run(di.make_step(cfg8, mesh), st8, 50)

    ee1 = np.asarray(m1.field_energy, np.float64)
    ee8 = np.asarray(m8.field_energy, np.float64)
    np.testing.assert_allclose(ee8, ee1, rtol=3e-3)
    ke1 = np.asarray(m1.kinetic_energy, np.float64)
    ke8 = np.asarray(m8.kinetic_energy, np.float64)
    np.testing.assert_allclose(ke8, ke1, rtol=1e-4)
    assert (np.asarray(m8.picard_iters) == 4).all()
    assert (np.asarray(m8.n_alive) == 16_000).all()
    assert np.asarray(m8.n_dropped).sum() == 0
    # total energy conserved over the run at the fixed iteration count
    tot8 = ee8 + ke8
    assert abs(tot8[-1] / tot8[0] - 1.0) < 2e-3
    with pytest.raises(ValueError, match="picard_accel"):
        di.DomainImplicitConfig(grid, dt, params.p2c, num_shards=8,
                                picard_accel="nope")


def test_domain_implicit_finalize_modes(problem):
    """Domain finalize modes: 'converged' (deposit-free) is bit-exact with
    'converged-deposit'; 'iterate' (reference last-iterate semantics)
    agrees within the Picard tolerance and matches the composed backend's
    iterate-return bit of physics more closely."""
    from pypic_tpu.parallel import domain_implicit as di

    grid, x, v, params = problem
    dt = 0.1 / params.wp
    mesh = make_mesh(8, axis="slabs")
    outs = {}
    for fin in ("converged", "converged-deposit", "iterate"):
        cfg = di.DomainImplicitConfig(
            grid, dt, params.p2c, num_shards=8, tol=1e-8, maxiter=40,
            halo=4, migrate_cap=2048, backend="fused", finalize=fin,
        )
        st = di.shard_state(
            di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg), mesh, cfg
        )
        outs[fin] = run(di.make_step(cfg, mesh), st, 20)
    s_nd, s_d = outs["converged"][0], outs["converged-deposit"][0]
    np.testing.assert_array_equal(np.asarray(s_nd.p), np.asarray(s_d.p))
    np.testing.assert_array_equal(np.asarray(s_nd.v), np.asarray(s_d.v))
    np.testing.assert_array_equal(np.asarray(s_nd.e), np.asarray(s_d.e))
    ee_nd = np.asarray(outs["converged"][1].field_energy, np.float64)
    ee_it = np.asarray(outs["iterate"][1].field_energy, np.float64)
    np.testing.assert_allclose(ee_it, ee_nd, rtol=3e-3)
    for fin in ("converged", "iterate"):
        assert np.asarray(outs[fin][1].n_dropped).sum() == 0
    # closed-form mean vs deposit mean: equal up to f32 reduction order
    cb_nd = np.asarray(outs["converged"][1].current_bias, np.float64)
    cb_d = np.asarray(outs["converged-deposit"][1].current_bias, np.float64)
    np.testing.assert_allclose(cb_nd, cb_d, rtol=1e-3)


def test_distributed_poisson_matches_fft_solve():
    """The substructured slab-local Poisson solve (O(ng/D) local + O(D)
    interface comm) matches the replicated FFT solve's zero-mean phi."""
    from jax.sharding import PartitionSpec as P
    import jax.numpy as jnp
    from pypic_tpu.ops import solve_periodic_neutralized
    from pypic_tpu.parallel.distributed_poisson import (
        make_distributed_periodic_poisson,
    )

    ng, d_tot, dx = 256, 8, 0.37
    rng = np.random.default_rng(5)
    rho = jnp.asarray(rng.normal(0.0, 1e-8, ng), jnp.float32)

    mesh = make_mesh(d_tot, axis="slabs")
    solve = make_distributed_periodic_poisson(ng, dx, d_tot, "slabs")
    phi_dist = jax.shard_map(
        solve, mesh=mesh, in_specs=(P("slabs"),), out_specs=P("slabs"),
        check_vma=False,
    )(rho)

    phi_fft = solve_periodic_neutralized(rho, dx)
    phi_fft = phi_fft - jnp.mean(phi_fft)
    scale = float(jnp.abs(phi_fft).max())
    np.testing.assert_allclose(
        np.asarray(phi_dist, np.float64), np.asarray(phi_fft, np.float64),
        atol=2e-5 * scale,
    )


def test_domain_explicit_distributed_solve_matches_replicated(problem):
    """field_solve='distributed' (slab-local substructured Poisson + 1-node
    halo gradient) reproduces the replicated-FFT trajectories."""
    grid, x, v, params = problem
    dt = 0.1 / params.wp
    mesh = make_mesh(8, axis="slabs")
    runs = {}
    for fs in ("replicated", "distributed"):
        dcfg = domain.DomainConfig(grid, dt, params.p2c, num_shards=8,
                                   migrate_cap=2048, field_solve=fs)
        dst = domain.shard_state(
            domain.init_state(x, v, -E_CHARGE, M_ELECTRON, dcfg), mesh, dcfg
        )
        runs[fs] = run(domain.make_step(dcfg, mesh), dst, 100)[1]
    ee_r = np.asarray(runs["replicated"].field_energy, np.float64)
    ee_d = np.asarray(runs["distributed"].field_energy, np.float64)
    np.testing.assert_allclose(ee_d, ee_r, rtol=2e-3)
    ke_r = np.asarray(runs["replicated"].kinetic_energy, np.float64)
    ke_d = np.asarray(runs["distributed"].kinetic_energy, np.float64)
    np.testing.assert_allclose(ke_d, ke_r, rtol=1e-4)
    assert (np.asarray(runs["distributed"].n_alive) == 16_000).all()
    assert np.asarray(runs["distributed"].n_dropped).sum() == 0


def _iead_like_domain_cfg(c1, **kw):
    from pypic_tpu.parallel import domain_magnetized as dm

    base = dict(
        grid=c1.grid, dt=c1.dt, te=c1.te, b=c1.b, species_z=c1.species_z,
        num_shards=8, ionization=c1.ionization, reactivate="source",
        source=c1.source, react_batch=512,
        iead_energy_max=c1.iead_energy_max, newton_tol=c1.newton_tol,
        newton_maxiter=c1.newton_maxiter, halo=2, migrate_cap=1024,
    )
    base.update(kw)
    return dm.DomainMagnetizedConfig(**base)


def _domain_mag_state(pre, cfg, mesh):
    from pypic_tpu.parallel import domain_magnetized as dm

    return dm.shard_state(dm.init_state(
        np.asarray(pre.state.p) * cfg.grid.dx,
        np.stack([pre.state.vx, pre.state.vy, pre.state.vz], -1),
        np.asarray(pre.state.m), np.asarray(pre.state.charge_state),
        np.asarray(pre.state.p2c), np.asarray(pre.state.species_idx),
        cfg), mesh, cfg)


def test_domain_magnetized_matches_single_device():
    """Slab-sharded magnetized engine (round-2 review stretch item 9): the
    distributed Newton-Boltzmann solve + slab deposits/halos reproduce the
    single-device pic_iead trajectory while correlated (f32 lsb summation
    differences then diverge chaotically through the absorb/re-activate
    feedback, as with the data-parallel engine)."""
    import dataclasses as dc
    from pypic_tpu.presets import pic_iead
    from pypic_tpu.parallel import make_mesh, domain_magnetized as dm
    from pypic_tpu.engines import magnetized
    from pypic_tpu.runner import run

    steps = 30
    pre = pic_iead(n_per_species=400)
    c1 = dc.replace(pre.config, source_sampler="threefry", react_batch=512)
    _, m1 = run(magnetized.make_step(c1), pre.state, steps)

    cfg = _iead_like_domain_cfg(c1)
    mesh = make_mesh(8, axis="slabs")
    st = _domain_mag_state(pre, cfg, mesh)
    stf, m8 = run(dm.make_step(cfg, mesh), st, steps)

    # tight while correlated — 2 steps since round 4: the reference's
    # swapped-weight gather quirk (gather_weights='reference') samples the
    # STEEPER cross-cell field near the walls, so f32 lsb differences
    # amplify through the absorb/re-activate feedback faster than the
    # pre-quirk dynamics did (measured: step 2 is already ~1e-2 apart;
    # steps 0-1 agree to ~2e-6)
    np.testing.assert_allclose(
        np.asarray(m8.phi_max, np.float64)[:2],
        np.asarray(m1.phi_max, np.float64)[:2], rtol=5e-4)
    np.testing.assert_allclose(
        np.asarray(m8.phi_max, np.float64)[:10],
        np.asarray(m1.phi_max, np.float64)[:10], rtol=2e-1)
    np.testing.assert_allclose(
        np.asarray(m8.n0, np.float64)[:10], np.asarray(m1.n0, np.float64)[:10],
        rtol=1e-2)
    np.testing.assert_allclose(
        np.asarray(m8.n0, np.float64), np.asarray(m1.n0, np.float64),
        rtol=2e-1)
    a1 = np.asarray(m1.n_active).astype(int)
    a8 = np.asarray(m8.n_active).astype(int)
    assert np.abs(a1 - a8).max() <= 4
    assert int(np.asarray(m8.n_dropped).sum()) == 0
    # IEAD totals agree on the psum'd channel (same wall flux statistics)
    tot1 = float(np.asarray(m1.n_hit_wall).sum())
    tot8 = float(np.asarray(m8.n_hit_wall).sum())
    assert abs(tot1 - tot8) <= 0.15 * max(tot1, 1.0), (tot1, tot8)


def test_domain_magnetized_solvers_agree():
    """'distributed' (substructured Newton, slab-sharded through every
    iteration) == 'replicated' (all_gather + ops.poisson) to f32 solver
    tolerance on identical states."""
    import dataclasses as dc
    from pypic_tpu.presets import pic_iead
    from pypic_tpu.parallel import make_mesh, domain_magnetized as dm
    from pypic_tpu.runner import run

    pre = pic_iead(n_per_species=400)
    c1 = dc.replace(pre.config, source_sampler="threefry")
    mesh = make_mesh(8, axis="slabs")
    outs = {}
    for solver in ("distributed", "replicated"):
        cfg = _iead_like_domain_cfg(c1, solver=solver)
        st = _domain_mag_state(pre, cfg, mesh)
        outs[solver] = run(dm.make_step(cfg, mesh), st, 10)
    phi_d = np.asarray(outs["distributed"][1].phi, np.float64)
    phi_r = np.asarray(outs["replicated"][1].phi, np.float64)
    scale = np.abs(phi_r).max()
    np.testing.assert_allclose(phi_d / scale, phi_r / scale, atol=2e-4)
    np.testing.assert_array_equal(
        np.asarray(outs["distributed"][1].n_active),
        np.asarray(outs["replicated"][1].n_active))


def test_domain_magnetized_config_gates():
    from pypic_tpu.presets import pic_iead
    from pypic_tpu.parallel import domain_magnetized as dm

    pre = pic_iead(n_per_species=10)
    c1 = pre.config
    with pytest.raises(ValueError, match="react_batch"):
        _iead_like_domain_cfg(c1, react_batch=0)
    with pytest.raises(ValueError, match="not divisible"):
        _iead_like_domain_cfg(c1, num_shards=7)
    with pytest.raises(ValueError, match="dirichlet-dirichlet"):
        from pypic_tpu.grid import GridSpec
        dn = GridSpec(600, c1.grid.length, "dirichlet-neumann")
        _iead_like_domain_cfg(c1, grid=dn)


def test_distributed_tridiag_chain_matches_thomas():
    """Runtime-coefficient Schur substructuring == the sequential Thomas
    solve, on Boltzmann-Jacobian-like and generic dominant systems."""
    from jax.sharding import PartitionSpec as P
    from pypic_tpu.parallel import make_mesh
    import jax.numpy as jnp
    from pypic_tpu.parallel.distributed_poisson import (
        make_distributed_tridiag_chain,
    )
    from pypic_tpu.ops import solve_tridiag

    ng, D = 640, 8
    mesh = make_mesh(8, axis="slabs")
    solve_dist = make_distributed_tridiag_chain(ng // D, D, "slabs")
    fn = jax.shard_map(solve_dist, mesh=mesh, in_specs=(P("slabs"),) * 4,
                       out_specs=P("slabs"), check_vma=False)
    rng = np.random.default_rng(5)
    dl = np.ones(ng, np.float32)
    du = np.ones(ng, np.float32)
    dl[-1] = 0.0
    du[0] = 0.0
    for kind in ("boltzmann", "generic"):
        if kind == "boltzmann":
            d = (-2.0 - np.exp(rng.normal(0, 1.5, ng)) * 20).astype(np.float32)
            d[0] = d[-1] = 1.0
        else:
            d = (rng.normal(0, 1, ng) + 4.0).astype(np.float32)
        f = rng.normal(0, 1, ng).astype(np.float32)
        ref = np.asarray(solve_tridiag(
            jnp.asarray(dl, jnp.float32), jnp.asarray(d),
            jnp.asarray(du, jnp.float32), jnp.asarray(f), method="thomas"))
        out = np.asarray(fn(jnp.asarray(dl, jnp.float32), jnp.asarray(d),
                            jnp.asarray(du, jnp.float32), jnp.asarray(f)))
        err = np.abs(out - ref).max() / np.abs(ref).max()
        assert err < 1e-4, (kind, err)


def test_domain_magnetized_ionization_and_capped_source():
    """Shard-local MCC ionization + the globally-capped 'capped-source'
    policy on the slab engine: ionization happens, the source population
    respects the global cap, ledgers stay finite."""
    import dataclasses as dc
    from pypic_tpu.presets import pic_iead
    from pypic_tpu.parallel import make_mesh, domain_magnetized as dm
    from pypic_tpu.runner import run

    pre = pic_iead(n_per_species=400)
    c1 = dc.replace(pre.config, ionization=True)
    cfg = _iead_like_domain_cfg(
        c1, ionization=True, reactivate="capped-source",
        source_n=500, react_batch=256)
    mesh = make_mesh(8, axis="slabs")
    st = _domain_mag_state(pre, cfg, mesh)
    stf, m = run(dm.make_step(cfg, mesh), st, 40)
    n_ion = np.asarray(m.n_ionized).astype(int)
    assert n_ion.sum() > 10  # boron neutrals ionize in the early steps
    # capped refill: active source-species population never exceeds the
    # cap by more than one step's re-activations
    assert int(np.asarray(m.n_reactivated).max()) <= 256
    assert np.isfinite(np.asarray(m.added)).all()
    assert int(np.asarray(m.n_dropped).sum()) == 0


def test_domain_magnetized_composed_2d_matches_1d():
    """Slabs x data-parallel composition for the magnetized engine (round
    3c, mirroring DomainImplicitConfig.dp_axis_name): 4 slabs x 2 replicas
    reproduces the 8-slab (1-replica) run's aggregate dynamics — per-
    replica deposits psum over dp, the Newton solve replicates per
    replica, and the re-activation cap allocates by global (slab, replica)
    slot rank."""
    import dataclasses as dc
    from pypic_tpu.presets import pic_iead
    from pypic_tpu.parallel import make_mesh2, make_mesh
    from pypic_tpu.parallel import domain_magnetized as dm
    from pypic_tpu.runner import run

    steps = 25
    pre = pic_iead(n_per_species=400, ng=64)
    c1 = dc.replace(pre.config, source_sampler="threefry", react_batch=512)

    cfg1 = _iead_like_domain_cfg(c1, num_shards=8, halo=2)
    mesh1 = make_mesh(8, axis="slabs")
    st1 = _domain_mag_state(pre, cfg1, mesh1)
    _, m1 = run(dm.make_step(cfg1, mesh1), st1, steps)

    cfg2 = _iead_like_domain_cfg(c1, num_shards=4, halo=2,
                                 dp_axis_name="dp", num_replicas=2)
    mesh2 = make_mesh2(4, 2, axes=("slabs", "dp"))
    st2 = _domain_mag_state(pre, cfg2, mesh2)
    _, m2 = run(dm.make_step(cfg2, mesh2), st2, steps)

    np.testing.assert_allclose(
        np.asarray(m2.phi_max, np.float64)[:8],
        np.asarray(m1.phi_max, np.float64)[:8], rtol=1e-3)
    a1 = np.asarray(m1.n_active).astype(int)
    a2 = np.asarray(m2.n_active).astype(int)
    assert np.abs(a1 - a2).max() <= 6, (a1, a2)
    assert int(np.asarray(m2.n_dropped).sum()) == 0
    # wall-flux statistics agree
    tot1 = float(np.asarray(m1.n_hit_wall).sum())
    tot2 = float(np.asarray(m2.n_hit_wall).sum())
    assert abs(tot1 - tot2) <= 0.2 * max(tot1, 1.0), (tot1, tot2)


# ---------------------------------------------------------------------------
# Migration-amortized superstep (make_superstep)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["composed", "fused"])
def test_domain_implicit_superstep_matches_per_step(problem, backend):
    """k-unrolled superstep (migrate ONCE, on the last micro-step) follows
    the per-step-migrate stepper's trajectories: same Picard envelope,
    energies to f32 reduction-order tolerance, population conserved, zero
    halo clamps when the halo covers the k-step excursion, and migration
    counts land only in the last micro-step slot."""
    from pypic_tpu.parallel import domain_implicit as di

    grid, x, v, params = problem
    dt = 0.1 / params.wp
    k = 4
    # 4 shards x 16-cell slabs leave room for a k-step halo (4 cells/step
    # covers this workload per the per-step test; k=4 -> halo 12)
    cfg = di.DomainImplicitConfig(
        grid, dt, params.p2c, num_shards=4, tol=1e-6, maxiter=40,
        halo=12, migrate_cap=4096, backend=backend,
    )
    mesh = make_mesh(4, axis="slabs")
    st0 = di.shard_state(
        di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg), mesh, cfg
    )
    _, m1 = run(di.make_step(cfg, mesh), st0, 2 * k)

    sup = jax.jit(di.make_superstep(cfg, mesh, k))
    s, chunks = st0, []
    for _ in range(2):
        s, m = sup(s)
        chunks.append(jax.tree.map(np.asarray, m))
    m2 = jax.tree.map(lambda *xs: np.concatenate(xs), *chunks)

    np.testing.assert_array_equal(
        np.asarray(m1.picard_iters), m2.picard_iters
    )
    np.testing.assert_allclose(
        m2.field_energy, np.asarray(m1.field_energy, np.float64), rtol=1e-4
    )
    np.testing.assert_allclose(
        m2.kinetic_energy, np.asarray(m1.kinetic_energy, np.float64),
        rtol=1e-5,
    )
    assert (m2.n_alive == 16_000).all()
    assert m2.n_dropped.sum() == 0
    assert m2.n_halo_clamped.sum() == 0
    # migration fires only on the last micro-step of each superstep
    assert (m2.n_migrated[[0, 1, 2, 4, 5, 6]] == 0).all()
    assert m2.n_migrated[[3, 7]].sum() > 0


@pytest.mark.parametrize("backend", ["composed", "fused"])
@pytest.mark.parametrize(
    "finalize", ["converged", "converged-deposit", "iterate"]
)
def test_domain_implicit_superstep_k1_bitexact(problem, backend, finalize):
    """make_superstep(cfg, mesh, 1) IS make_step with a (1,)-stacked
    metrics axis: bit-identical particle state across every finalize mode
    and backend (the superstep's shifted-coordinate micro-step reduces to
    the per-step path when the last micro-step is the only one)."""
    from pypic_tpu.parallel import domain_implicit as di

    grid, x, v, params = problem
    dt = 0.1 / params.wp
    mesh = make_mesh(8, axis="slabs")
    cfg = di.DomainImplicitConfig(
        grid, dt, params.p2c, num_shards=8, tol=1e-6, maxiter=40,
        halo=4, migrate_cap=2048, backend=backend, finalize=finalize,
    )
    st0 = di.shard_state(
        di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg), mesh, cfg
    )
    s1, m1 = jax.jit(di.make_step(cfg, mesh))(st0)
    s2, m2 = jax.jit(di.make_superstep(cfg, mesh, 1))(st0)
    if finalize == "iterate" and backend == "fused":
        # the iterate finalize rebuilds p1 in the kernels' shifted frame
        # (p0l + hw ... - hw), a <=1-ulp rounding difference vs the
        # per-step path; the Picard loop itself is identical (v, e exact)
        np.testing.assert_allclose(
            np.asarray(s1.p), np.asarray(s2.p), atol=1e-4, rtol=0
        )
    else:
        np.testing.assert_array_equal(np.asarray(s1.p), np.asarray(s2.p))
    np.testing.assert_array_equal(np.asarray(s1.v), np.asarray(s2.v))
    np.testing.assert_array_equal(np.asarray(s1.e), np.asarray(s2.e))
    assert np.asarray(m2.field_energy).shape == (1,)
    np.testing.assert_allclose(
        np.asarray(m2.field_energy)[0], np.asarray(m1.field_energy),
        rtol=1e-6,
    )
    assert int(np.asarray(m2.picard_iters)[0]) == int(
        np.asarray(m1.picard_iters)
    )


def test_domain_implicit_superstep_counts_halo_violations(problem):
    """A particle outrunning the halo mid-superstep is counted (per
    micro-step), never silent: with an undersized halo the superstep
    reports nonzero n_halo_clamped."""
    from pypic_tpu.parallel import domain_implicit as di

    grid, x, v, params = problem
    dt = 0.4 / params.wp  # large steps force multi-cell excursions
    mesh = make_mesh(8, axis="slabs")
    cfg = di.DomainImplicitConfig(
        grid, dt, params.p2c, num_shards=8, tol=1e-6, maxiter=40,
        halo=1, migrate_cap=4096, backend="fused",
    )
    st0 = di.shard_state(
        di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg), mesh, cfg
    )
    _, m = jax.jit(di.make_superstep(cfg, mesh, 3))(st0)
    assert np.asarray(m.n_halo_clamped).sum() > 0
    assert (np.asarray(m.n_alive) == 16_000).all()


def test_domain_implicit_superstep_2d_mesh(problem):
    """Superstep composes with the slabs x dp 2D mesh: replica-psum'd
    deposits and the migrate round-count rendezvous hold when migration
    only fires on the last micro-step."""
    from pypic_tpu.parallel import domain_implicit as di
    from pypic_tpu.parallel import make_mesh2

    grid, x, v, params = problem
    dt = 0.1 / params.wp
    mesh = make_mesh2(4, 2, axes=("slabs", "dp"))
    cfg = di.DomainImplicitConfig(
        grid, dt, params.p2c, num_shards=4, tol=1e-6, maxiter=40,
        halo=8, migrate_cap=2048, dp_axis_name="dp", num_replicas=2,
        backend="fused",
    )
    st0 = di.shard_state(
        di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg), mesh, cfg
    )
    _, m1 = run(di.make_step(cfg, mesh), st0, 4)
    s, m2 = jax.jit(di.make_superstep(cfg, mesh, 2))(st0)
    s, m2b = jax.jit(di.make_superstep(cfg, mesh, 2))(s)
    fe2 = np.concatenate(
        [np.asarray(m2.field_energy), np.asarray(m2b.field_energy)]
    )
    np.testing.assert_allclose(
        fe2, np.asarray(m1.field_energy, np.float64), rtol=1e-4
    )
    alive = np.concatenate(
        [np.asarray(m2.n_alive), np.asarray(m2b.n_alive)]
    )
    assert (alive == 16_000).all()


def test_domain_implicit_superstep_rejects_bad_k(problem):
    from pypic_tpu.parallel import domain_implicit as di

    grid, x, v, params = problem
    cfg = di.DomainImplicitConfig(
        grid, 0.1 / params.wp, params.p2c, num_shards=8
    )
    mesh = make_mesh(8, axis="slabs")
    with pytest.raises(ValueError, match="migrate_every"):
        di.make_superstep(cfg, mesh, 0)


@pytest.mark.parametrize("ff", ["map", "mean2", "aitken"])
def test_domain_implicit_finalize_field_matches_single_device(problem, ff):
    """finalize_field on the slab-sharded engine == the single-device fused
    engine in the headline fixed-count configuration (the aitken Δ² inner
    products psum over the slab axis, so the sharded extrapolation equals
    the global one up to f32 reduction order)."""
    from pypic_tpu.engines import implicit
    from pypic_tpu.parallel import domain_implicit as di

    grid, x, v, params = problem
    dt = 0.1 / params.wp
    kw = dict(tol=1e-30, maxiter=3, picard_init="extrapolate",
              picard_accel="anderson", finalize_field=ff, backend="fused")

    cfg1 = implicit.ImplicitConfig(grid, dt, params.p2c, **kw)
    st1 = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg1)
    _, m1 = run(implicit.make_step(cfg1), st1, 50)

    mesh = make_mesh(8, axis="slabs")
    cfg8 = di.DomainImplicitConfig(
        grid, dt, params.p2c, num_shards=8, halo=4, migrate_cap=2048, **kw
    )
    st8 = di.shard_state(
        di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg8), mesh, cfg8
    )
    _, m8 = run(di.make_step(cfg8, mesh), st8, 50)

    ee1 = np.asarray(m1.field_energy, np.float64)
    ee8 = np.asarray(m8.field_energy, np.float64)
    np.testing.assert_allclose(ee8, ee1, rtol=1e-4)
    ke1 = np.asarray(m1.kinetic_energy, np.float64)
    ke8 = np.asarray(m8.kinetic_energy, np.float64)
    np.testing.assert_allclose(ke8, ke1, rtol=1e-5)
    assert (np.asarray(m8.n_alive) == 16_000).all()
    assert np.asarray(m8.n_dropped).sum() == 0
    # both run the fixed count; trajectories stay bounded and conservative
    assert (np.asarray(m8.picard_iters) == 3).all()
    tot8 = ee8 + ke8
    assert abs(tot8[-1] / tot8[0] - 1.0) < 1e-2


def test_domain_implicit_finalize_field_superstep_k1_bitexact(problem):
    """make_superstep(k=1) with finalize_field='aitken' is bit-exact with
    make_step — the shared micro-step builder carries the same map-output
    history through both entry points."""
    from pypic_tpu.parallel import domain_implicit as di

    grid, x, v, params = problem
    dt = 0.1 / params.wp
    mesh = make_mesh(8, axis="slabs")
    cfg = di.DomainImplicitConfig(
        grid, dt, params.p2c, num_shards=8, tol=1e-30, maxiter=3,
        picard_init="extrapolate", picard_accel="anderson",
        finalize_field="aitken", backend="fused", halo=4, migrate_cap=2048,
    )
    st0 = di.shard_state(
        di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg), mesh, cfg
    )
    s_a, m_a = run(di.make_step(cfg, mesh), st0, 10)
    s_b, m_b = run(di.make_superstep(cfg, mesh, 1), st0, 10)
    np.testing.assert_array_equal(np.asarray(s_a.p), np.asarray(s_b.p))
    np.testing.assert_array_equal(np.asarray(s_a.v), np.asarray(s_b.v))
    np.testing.assert_array_equal(np.asarray(s_a.e), np.asarray(s_b.e))
    np.testing.assert_array_equal(
        np.asarray(m_a.field_energy), np.asarray(m_b.field_energy).reshape(-1)
    )


def test_domain_implicit_finalize_field_composed_rejected(problem):
    """The composed backend has no finalize sweep to redirect."""
    from pypic_tpu.parallel import domain_implicit as di

    grid, x, v, params = problem
    cfg = di.DomainImplicitConfig(
        grid, 0.1 / params.wp, params.p2c, num_shards=8,
        finalize_field="aitken", backend="composed",
    )
    mesh = make_mesh(8, axis="slabs")
    with pytest.raises(ValueError, match="fused backend"):
        di.make_step(cfg, mesh)
    with pytest.raises(ValueError, match="unknown finalize_field"):
        di.DomainImplicitConfig(
            grid, 0.1 / params.wp, params.p2c, num_shards=8,
            finalize_field="nope",
        )
    # finalize='iterate' + non-default finalize_field rejected at config
    # time (it would otherwise be silently ignored — the composed-backend
    # combination raises loudly, this one now matches)
    with pytest.raises(ValueError, match="no finalize sweep"):
        di.DomainImplicitConfig(
            grid, 0.1 / params.wp, params.p2c, num_shards=8,
            finalize="iterate", finalize_field="aitken",
        )
