"""Checkpoint/resume: bit-exact restart (vs the reference's unversioned
whole-object pickling, pygcpic.py:1627-1632)."""

import jax
import numpy as np
import pytest

from pypic_tpu import checkpoint
from pypic_tpu.constants import E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON
from pypic_tpu.grid import GridSpec
from pypic_tpu import initialize as init
from pypic_tpu.engines import implicit, sheath
from pypic_tpu.runner import run


def _implicit_setup():
    density = 1e10
    te = 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(64, 15.0 * debye, "periodic")
    x, v, params = init.initialize_periodic(
        "two-stream", 8000, density, 1, 0.05, grid, te, te, seed=2
    )
    cfg = implicit.ImplicitConfig(grid, 0.1 / params.wp, params.p2c, tol=1e-5)
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
    return cfg, st


def test_save_load_roundtrip_bitexact(tmp_path):
    cfg, st = _implicit_setup()
    step = implicit.make_step(cfg)
    mid, _ = run(step, st, 10)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, mid, step=10)
    restored, manifest = checkpoint.load(path, st)
    assert manifest["step"] == 10
    for a, b in zip(
        __import__("jax").tree_util.tree_leaves(mid),
        __import__("jax").tree_util.tree_leaves(restored),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_explicit_state_checkpoint_with_field_invariants(tmp_path):
    """The explicit engine's carried rho/e fields survive a save/load
    round-trip and an old checkpoint written WITHOUT them restores from
    the template (name-based layout), preserving the step invariant
    rho == deposit(p), e == solve(rho) for the resumed run."""
    from pypic_tpu.engines import explicit

    density = 1e10
    te = 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(64, 15.0 * debye, "periodic")
    x, v, params = init.initialize_periodic(
        "two-stream", 8000, density, 1, 0.05, grid, te, te, seed=2
    )
    cfg = explicit.ExplicitConfig(grid, 0.1 / params.wp, params.p2c)
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
    step = explicit.make_step(cfg)
    mid, _ = run(step, st, 10)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, mid, step=10)
    restored, _ = checkpoint.load(path, st)
    end_direct, _ = run(step, mid, 10)
    end_resumed, _ = run(step, restored, 10)
    np.testing.assert_array_equal(np.asarray(end_direct.p),
                                  np.asarray(end_resumed.p))
    np.testing.assert_array_equal(np.asarray(end_direct.e),
                                  np.asarray(end_resumed.e))

    # a legacy checkpoint missing the rho/e leaves: simulate by saving a
    # pruned pytree, then restoring into the full template — the carried
    # fields fall back to the template's (consistent) values
    from pypic_tpu.utils.pytree import PyTreeNode

    class OldState(PyTreeNode):
        p: object
        v: object
        q: object
        m: object
        step: object

    old = OldState(p=mid.p, v=mid.v, q=mid.q, m=mid.m, step=mid.step)
    path2 = str(tmp_path / "old.npz")
    checkpoint.save(path2, old, step=10)
    restored2, _ = checkpoint.load(path2, st)
    np.testing.assert_array_equal(np.asarray(restored2.p),
                                  np.asarray(mid.p))
    # template fallback leaves rho/e describing the WRONG particle
    # configuration; refresh_fields re-establishes the invariant (its
    # deposit uses a different summation order than the in-kernel one, so
    # agreement is to f32 reduction tolerance, not bit-exact)
    refreshed = explicit.refresh_fields(restored2, cfg)
    np.testing.assert_allclose(np.asarray(refreshed.rho),
                               np.asarray(mid.rho), rtol=1e-5)
    end2, _ = run(step, refreshed, 10)
    np.testing.assert_allclose(np.asarray(end2.p),
                               np.asarray(end_direct.p), atol=1e-3)


def test_resume_reproduces_trajectory_bitexact(tmp_path):
    """run(20) == run(10); save; load; run(10) — including the RNG-carrying
    sheath engine."""
    density = 1e19
    ng, dt, dx = 31, 1e-12, 1e-5
    te = ti = 10.0 * 11600.0
    grid = GridSpec(ng, dx * (ng - 1), "dirichlet-dirichlet")
    d = init.initialize_sheath(2000, density, 1.0, 0.0, grid, te, ti, seed=3)
    cfg = sheath.SheathConfig(
        grid, dt, grid.length * density / 2000,
        kbte=K_BOLTZMANN * te, kbti=K_BOLTZMANN * ti,
    )
    st = sheath.init_state(d["x"], d["v"], d["q"], d["m"], d["species"], cfg, seed=1)
    step = sheath.make_step(cfg)

    full, _ = run(step, st, 20)
    half, _ = run(step, st, 10)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, half, step=10)
    resumed, _ = checkpoint.load(path, st)
    full2, _ = run(step, resumed, 10)
    import jax

    for a, b in zip(jax.tree_util.tree_leaves(full), jax.tree_util.tree_leaves(full2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_manager_cadence_and_gc(tmp_path):
    cfg, st = _implicit_setup()
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpts"), every=5, keep=2)
    for s in range(1, 21):
        mgr.maybe_save(st, s)
    assert mgr.steps() == [15, 20]
    assert mgr.latest() == 20
    restored, manifest = mgr.restore(st)
    assert manifest["step"] == 20


def test_load_rejects_shape_mismatch(tmp_path):
    cfg, st = _implicit_setup()
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, st)
    bad_template = st.replace(p=st.p[:100])
    with pytest.raises(ValueError, match="leaf"):
        checkpoint.load(path, bad_template)


def test_restore_tolerates_added_state_field(tmp_path):
    """A checkpoint written before an engine gained a state field restores
    with the template's value for the new leaf (name-based v2 layout)."""
    import dataclasses

    from pypic_tpu import checkpoint

    @dataclasses.dataclass
    class Old:
        a: object
        b: object

    @dataclasses.dataclass
    class New:
        a: object
        b: object
        c: object

    import jax

    jax.tree_util.register_dataclass(Old, data_fields=["a", "b"],
                                     meta_fields=[])
    jax.tree_util.register_dataclass(New, data_fields=["a", "b", "c"],
                                     meta_fields=[])
    path = str(tmp_path / "old.npz")
    checkpoint.save(path, Old(a=np.arange(4.0), b=np.float32(2.0)), step=7)
    template = New(a=np.zeros(4), b=np.float32(0.0), c=np.float32(9.0))
    restored, manifest = checkpoint.load(path, template)
    np.testing.assert_array_equal(np.asarray(restored.a), np.arange(4.0))
    assert float(restored.b) == 2.0
    assert float(restored.c) == 9.0  # template fallback for the new field
    assert manifest["step"] == 7


def test_sheath_v_leaf_migration(tmp_path):
    """A round-2 sheath checkpoint stored velocities as one (n, 3) ``v``
    leaf; CHECKPOINT_MIGRATIONS splits it into the round-3 u/vy/vz leaves
    bit-exactly on restore (checkpoint.load(migrate=...), applied by cli
    --resume)."""
    import dataclasses

    import jax

    grid = GridSpec(17, 1e-4, "dirichlet-dirichlet")
    cfg = sheath.SheathConfig(
        grid, 1e-12, 1e8, kbte=K_BOLTZMANN * 1e5, kbti=K_BOLTZMANN * 1e5
    )
    rng = np.random.default_rng(0)
    n = 200
    st = sheath.init_state(
        rng.uniform(0, grid.length, n), rng.normal(size=(n, 3)),
        np.full(n, -E_CHARGE), np.full(n, M_ELECTRON),
        np.ones(n, np.int32), cfg,
    )

    # simulate the old layout: same leaves but with v stacked
    @dataclasses.dataclass
    class OldSheath:
        p: object
        v: object
        q: object
        m: object
        species: object
        active: object
        e: object
        j: object
        e_prev: object
        rng: object
        exit_hist: object
        step: object

    jax.tree_util.register_dataclass(
        OldSheath,
        data_fields=["p", "v", "q", "m", "species", "active", "e", "j",
                     "e_prev", "rng", "exit_hist", "step"],
        meta_fields=[],
    )
    old = OldSheath(
        p=st.p, v=np.asarray(st.v), q=st.q, m=st.m, species=st.species,
        active=st.active, e=st.e, j=st.j, e_prev=st.e_prev, rng=st.rng,
        exit_hist=st.exit_hist, step=st.step,
    )
    path = str(tmp_path / "old_sheath.npz")
    checkpoint.save(path, old, step=5)
    with pytest.raises(ValueError, match="not in the template"):
        checkpoint.load(path, st)
    restored, _ = checkpoint.load(path, st,
                                  migrate=sheath.CHECKPOINT_MIGRATIONS)
    np.testing.assert_array_equal(np.asarray(restored.u), np.asarray(st.u))
    np.testing.assert_array_equal(np.asarray(restored.vy), np.asarray(st.vy))
    np.testing.assert_array_equal(np.asarray(restored.vz), np.asarray(st.vz))


def test_checkpoint_manager_strided_cadence(tmp_path):
    """maybe_save fires on every-boundary crossings even when the caller
    advances in strides that never hit exact multiples (the batched BCA
    driver, pic_steps_per_bca=7)."""
    from pypic_tpu import checkpoint

    mgr = checkpoint.CheckpointManager(str(tmp_path / "ck"), every=100)
    state = {"x": np.arange(3.0)}
    saved = [s for s in range(7, 800, 7) if mgr.maybe_save(state, s)]
    assert saved  # crossings at 105, 203, ...
    assert saved[0] == 105
    assert len(saved) == 7  # one save per century crossed below 800


def test_checkpoint_resume_domain_implicit_sharded_bitexact(tmp_path):
    """Sharded checkpoint/resume (VERDICT round-2 item 5): a domain-
    decomposed state on the 8-device mesh saves (gather-to-host npz),
    restores into a fresh template, re-shards, and reproduces the
    uninterrupted trajectory bit-exactly."""
    import jax

    from pypic_tpu.parallel import domain_implicit as di, make_mesh

    density = 1e10
    te = 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(64, 15.0 * debye, "periodic")
    x, v, params = init.initialize_periodic(
        "two-stream", 8192, density, 1, 0.05, grid, te, te, seed=2
    )
    cfg = di.DomainImplicitConfig(
        grid, 0.1 / params.wp, params.p2c, num_shards=8,
        tol=1e-5, maxiter=20, halo=4, migrate_cap=512,
    )
    mesh = make_mesh(8, axis="slabs")
    st0 = di.shard_state(
        di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg), mesh, cfg
    )
    step = di.make_step(cfg, mesh)

    mid, _ = run(step, st0, 3)
    path = str(tmp_path / "dom.npz")
    checkpoint.save(path, mid, step=3)
    final_a, _ = run(step, mid, 3)

    # restore into a template built from DIFFERENT initial conditions
    x2, v2, _ = init.initialize_periodic(
        "two-stream", 8192, density, 1, 0.05, grid, te, te, seed=7
    )
    template = di.shard_state(
        di.init_state(x2, v2, -E_CHARGE, M_ELECTRON, cfg), mesh, cfg
    )
    restored, manifest = checkpoint.load(path, template)
    assert manifest["step"] == 3
    restored = di.shard_state(restored, mesh, cfg)
    final_b, _ = run(step, restored, 3)

    for a, b in zip(jax.tree_util.tree_leaves(final_a),
                    jax.tree_util.tree_leaves(final_b)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_resume_data_parallel_magnetized_bitexact(tmp_path):
    """Data-parallel magnetized state (psum'd deposits, counter-based
    re-activation): save/restore/re-shard on the 8-device mesh reproduces
    the uninterrupted trajectory bit-exactly."""
    import dataclasses as dc

    import jax

    from pypic_tpu.engines import magnetized
    from pypic_tpu.presets import pic_iead
    from pypic_tpu.parallel import make_mesh, make_data_parallel_step
    from pypic_tpu.parallel.dataparallel import shard_state

    pre = pic_iead(n_per_species=400)
    cfg8 = dc.replace(pre.config, axis_name="particles")
    mesh = make_mesh(8)
    step8 = make_data_parallel_step(
        magnetized.make_step, cfg8, mesh, example_state=pre.state
    )
    st0 = shard_state(pre.state, mesh)
    mid, _ = run(step8, st0, 3)
    path = str(tmp_path / "dp.npz")
    checkpoint.save(path, mid, step=3)
    final_a, _ = run(step8, mid, 3)

    pre2 = pic_iead(n_per_species=400, seed=9)
    restored, _ = checkpoint.load(path, shard_state(pre2.state, mesh))
    restored = shard_state(restored, mesh)
    final_b, _ = run(step8, restored, 3)

    for a, b in zip(jax.tree_util.tree_leaves(final_a),
                    jax.tree_util.tree_leaves(final_b)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_resume_domain_magnetized_bitexact(tmp_path):
    """Slab-sharded magnetized state (distributed Newton, rank-keyed
    re-activation, owner migration): save/restore/re-shard on the
    8-device mesh reproduces the uninterrupted trajectory bit-exactly."""
    import jax

    from pypic_tpu.presets import pic_iead_dd

    pre = pic_iead_dd(n_per_species=200, ng=104, shards=8)
    step = pre.make_step()
    mid, _ = run(step, pre.state, 3)
    path = str(tmp_path / "dmag.npz")
    checkpoint.save(path, mid, step=3)
    final_a, _ = run(step, mid, 3)

    template = pic_iead_dd(n_per_species=200, ng=104, shards=8,
                           seed=5).state
    restored, manifest = checkpoint.load(path, template)
    assert manifest["step"] == 3
    restored = pre.meta["reshard"](restored)
    final_b, _ = run(step, restored, 3)
    for a, b in zip(jax.tree_util.tree_leaves(final_a),
                    jax.tree_util.tree_leaves(final_b)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_async_checkpoint_bit_exact_and_ordered(tmp_path):
    """async_write=True: saves land on a background thread, bit-exact with
    the sync writer, ordered, gc'd, and drained by wait()/close()."""
    import dataclasses as dc

    from pypic_tpu import checkpoint
    from pypic_tpu.engines import implicit

    cfg, st = _implicit_setup()
    step = jax.jit(implicit.make_step(cfg))
    mgr_a = checkpoint.CheckpointManager(str(tmp_path / "async"), every=2,
                                         keep=2, async_write=True)
    mgr_s = checkpoint.CheckpointManager(str(tmp_path / "sync"), every=2,
                                         keep=2)
    s = st
    for i in range(1, 7):
        s, _ = step(s)
        a = mgr_a.maybe_save(s, i)
        b = mgr_s.maybe_save(s, i)
        assert a == b
    mgr_a.close()
    assert mgr_a.steps() == mgr_s.steps()  # ordering + gc identical
    ra, _ = mgr_a.restore(st)
    rs, _ = mgr_s.restore(st)
    for la, ls in zip(jax.tree.leaves(ra), jax.tree.leaves(rs)):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(ls))


def test_async_checkpoint_restore_waits_for_pending(tmp_path):
    """restore() of a checkpoint whose async write is still in flight
    drains the writer first (no FileNotFoundError race)."""
    from pypic_tpu import checkpoint
    from pypic_tpu.engines import implicit

    cfg, st = _implicit_setup()
    mgr = checkpoint.CheckpointManager(str(tmp_path), every=1,
                                       async_write=True)
    assert mgr.maybe_save(st, 1)
    restored, manifest = mgr.restore(st)  # no explicit wait()
    assert manifest["step"] == 1
    for l1, l2 in zip(jax.tree.leaves(restored), jax.tree.leaves(st)):
        np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))
    mgr.close()


def test_async_checkpoint_writer_error_surfaces(tmp_path, monkeypatch):
    """A writer-thread failure is raised on the NEXT save — never silent."""
    from pypic_tpu import checkpoint
    from pypic_tpu.engines import implicit

    cfg, st = _implicit_setup()
    mgr = checkpoint.CheckpointManager(str(tmp_path), every=1,
                                       async_write=True)

    def boom(*a, **k):
        raise OSError("disk on fire")

    real_write = checkpoint._write_npz
    monkeypatch.setattr(checkpoint, "_write_npz", boom)
    assert mgr.maybe_save(st, 1)
    with pytest.raises(OSError, match="disk on fire"):
        mgr.maybe_save(st, 2)
    # the failed window's cadence rolled back: once the writer recovers,
    # the next boundary retries rather than skipping the window forever
    monkeypatch.setattr(checkpoint, "_write_npz", real_write)
    assert mgr.maybe_save(st, 2)
    mgr.close()
    assert mgr.steps() == [2]
