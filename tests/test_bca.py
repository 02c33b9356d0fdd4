"""BCA surface-coupling tests: interface contract, particle construction,
injection, and the hybrid driver loop (pic_bca_aps rebuild)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pypic_tpu import bca, presets
from pypic_tpu.constants import E_CHARGE, M_PROTON
from pypic_tpu.engines import bca_driver, magnetized


def test_null_bca_empty():
    s, r = bca.NullBCA().run([10.0, 20.0], [5.0, 10.0])
    assert s.shape == (0, 6) and r.shape == (0, 6)


def test_binary_collision_model_yield_behavior():
    model = bca.BinaryCollisionModel(seed=0)
    # below threshold: no sputtering
    s, r = model.run(np.full(1000, 5.0), np.zeros(1000))
    assert len(s) == 0
    # far above threshold: yield near y0, sputtered rows are wall species
    s, r = model.run(np.full(5000, 500.0), np.zeros(5000))
    y = len(s) / 5000
    assert 0.05 < y < 0.15
    assert (s[:, 5] == 5).all() and np.allclose(s[:, 4], 10.81)
    # reflected rows are incident species with reduced energy
    assert (r[:, 5] == 1).all()
    assert (r[:, 0] < 500.0).all()
    # direction cosines normalized-ish, ca > 0 (outgoing)
    norms = np.linalg.norm(s[:, 1:4], axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-12)
    assert (s[:, 1] > 0).all()


def test_particles_from_energy_angle():
    rng = np.random.default_rng(0)
    rows = np.asarray([
        [100.0, 1.0, 0.0, 0.0, 1.0, 1],     # H, 100 eV, normal incidence
        [3.0, 0.5, 0.5, 0.7071, 10.81, 5],  # B, 3 eV
    ])
    sides = np.asarray([0.0, 1.0])  # left wall, right wall
    batch = bca.particles_from_energy_angle(rows, sides, 1e-10, 1e-3, 1e10, rng)
    # speeds match E = m v^2 / 2
    speed = np.linalg.norm(batch["v"], axis=1)
    expect0 = np.sqrt(2 * 100.0 * E_CHARGE / M_PROTON)
    np.testing.assert_allclose(speed[0], expect0, rtol=1e-6)
    # direction off the wall: left wall -> vx > 0; right -> vx < 0
    assert batch["v"][0, 0] > 0 and batch["v"][1, 0] < 0
    # start position offset into the domain from the correct wall
    assert 0.0 <= batch["x"][0] < 1e-3 / 2
    assert 1e-3 / 2 < batch["x"][1] <= 1e-3
    assert (batch["charge_state"] == 0).all()
    assert list(batch["z"]) == [1, 5]


def _bca_setup(ppc=10, headroom=1.5):
    # the preset ships BCA-ready (capped-source + headroom + impact buffer)
    pre = presets.pic_bca_aps(ppc=ppc, capacity_factor=headroom)
    return pre.config, pre.state, pre


def test_inject_claims_free_slots():
    cfg, st, pre = _bca_setup(ppc=5)
    inject = magnetized.make_inject(cfg)
    k = 8
    st2, n_inj, n_drop = inject(
        st,
        jnp.full(k, cfg.grid.length / 2, jnp.float32),
        jnp.zeros((k, 2), jnp.float32),
        jnp.ones((k, 3), jnp.float32) * 1e4,
        jnp.full(k, 10.81 * M_PROTON, jnp.float32),
        jnp.zeros(k, jnp.float32),
        jnp.full(k, 1e10, jnp.float32),
        jnp.ones(k, jnp.int32),
        jnp.zeros(k, jnp.float32),
        jnp.ones(k, bool),
    )
    assert int(n_inj) == k and int(n_drop) == 0
    gained = int(jnp.sum(st2.active == 1)) - int(jnp.sum(st.active == 1))
    assert gained == k
    newly = (np.asarray(st2.active) == 1) & (np.asarray(st.active) != 1)
    assert (np.asarray(st2.from_wall)[newly] == 1).all()
    assert (np.asarray(st2.species_idx)[newly] == 1).all()


def test_inject_drops_overflow():
    cfg, st, pre = _bca_setup(ppc=5, headroom=1.0)  # zero free slots
    # fill every slot first so no free slot exists (capped-source would
    # otherwise refill them only next step)
    st = st.replace(active=jnp.ones_like(st.active))
    inject = magnetized.make_inject(cfg)
    k = 4
    _, n_inj, n_drop = inject(
        st,
        jnp.zeros(k, jnp.float32), jnp.zeros((k, 2), jnp.float32),
        jnp.zeros((k, 3), jnp.float32), jnp.ones(k, jnp.float32),
        jnp.zeros(k, jnp.float32), jnp.ones(k, jnp.float32),
        jnp.zeros(k, jnp.int32), jnp.zeros(k, jnp.float32),
        jnp.ones(k, bool),
    )
    assert int(n_inj) == 0 and int(n_drop) == k


def test_bca_driver_full_chain(tmp_path):
    """H plasma vs B wall with the empirical surface model: impacts are
    collected, products are injected as neutral wall atoms, some ionize."""
    cfg, st, pre = _bca_setup(ppc=10)
    model_sw = bca.BinaryCollisionModel(seed=1)
    model_ww = bca.BinaryCollisionModel(incident_m_amu=10.81, incident_z=5, seed=2)
    events = str(tmp_path / "events")
    fin, stats, hist = bca_driver.run_bca(
        st, cfg, 120, model_sw, model_ww,
        product_p2c=float(np.asarray(st.p2c)[0]), seed=3,
        write_particles=events,
    )
    # reference write_particles event streams (pygcpic.py:1440-1527): one
    # vx/vth line per wall impact split by species; lateral displacements
    # for the wall species; line counts match the incident counters
    import os

    src_vx = np.loadtxt(os.path.join(events, "source_wall.dat"))
    wall_vx = np.loadtxt(os.path.join(events, "wall_wall.dat"))
    lat = np.loadtxt(os.path.join(events, "lateral_displacements.dat"))
    assert src_vx.size == stats.source_incident
    assert wall_vx.size == stats.wall_incident
    assert lat.size == stats.wall_incident
    assert np.isfinite(src_vx).all() and np.isfinite(lat).all()
    # impacts arrive AT a wall: vx/vth is O(sheath-accelerated thermal)
    assert 0.0 < np.abs(np.atleast_1d(src_vx)).max() < 1e3
    assert (np.atleast_1d(lat) >= 0.0).all()
    assert 0 <= stats.redeposited <= stats.wall_incident
    # product-injection streams: one vx/vth line per injected BCA product
    fw = np.concatenate([
        np.atleast_1d(np.loadtxt(os.path.join(events, f"{s}_from_wall.dat")))
        for s in ("source", "wall")
        if os.path.getsize(os.path.join(events, f"{s}_from_wall.dat")) > 0
    ])
    assert fw.size == stats.injected + stats.dropped
    assert np.isfinite(fw).all()
    assert stats.source_incident > 100
    assert stats.sputtered > 0 and stats.source_reflected > 0
    assert stats.injected > 0 and stats.dropped == 0
    assert stats.source_incident > 0
    act = np.asarray(fin.active) == 1
    assert (np.asarray(fin.from_wall)[act] == 1).sum() > 0
    boron_alive = (np.asarray(fin.species_idx)[act] == 1).sum()
    assert boron_alive > 0
    # yield bounded and sane
    assert 0.0 < stats.total_yield() < 0.5
    # capped-source policy holds the ionized H population at source_n
    n_h = int(
        (
            (np.asarray(fin.species_idx) == 0)
            & act
            & (np.asarray(fin.charge_state) > 0)
        ).sum()
    )
    assert n_h == pre.meta["source_n"]


def test_bca_escape_region_deactivates_wall_born():
    """pygcpic.py:1529-1541: from_wall particles reaching length/2 +/-
    length/8 are deactivated and recorded in the escape IEAD."""
    cfg, st, pre = _bca_setup(ppc=5)
    # plant a wall-born particle mid-domain, moving slowly (stays in region)
    mid = cfg.grid.num_cells / 2.0
    st = st.replace(
        p=st.p.at[0].set(mid),
        vx=st.vx.at[0].set(1.0),
        vy=st.vy.at[0].set(0.0),
        vz=st.vz.at[0].set(0.0),
        from_wall=st.from_wall.at[0].set(1),
        charge_state=st.charge_state.at[0].set(0.0),  # neutral: no cap refill
    )
    step = magnetized.make_step(cfg)
    st2, m = step(st)
    assert int(m.n_escaped) >= 1
    # per-event escape rows (the {source,wall}_out.dat stream): vx/vth,
    # species_idx, energy_eV, angle_deg of the planted slow wall-born row
    assert int(m.n_escape_rows) >= 1
    esc = np.asarray(m.escapes)[: int(m.n_escape_rows)]
    assert np.isfinite(esc).all()
    assert (esc[:, 2] >= 0.0).all() and (0.0 <= esc[:, 3]).all()
    assert (esc[:, 3] <= 90.0).all()
    # the escaped particle is gone: its slot is either free or already
    # recycled by the capped-source refill as a fresh (from_wall=0) H ion
    assert int(st2.active[0]) == 0 or int(st2.from_wall[0]) == 0
    assert float(jnp.sum(st2.iead_out)) >= 1.0


def test_iead_excludes_out_of_range_impacts():
    """np.histogram2d range semantics (pygcpic.py:1259): impacts beyond
    iead_energy_max are discarded, not clipped into the top bin."""
    cfg, st, pre = _bca_setup(ppc=5)
    # launch one particle through the wall at huge energy (>> 300 eV max)
    v_huge = 5e6  # ~130 keV for H
    st = st.replace(
        p=st.p.at[0].set(0.5),
        vx=st.vx.at[0].set(-v_huge),
        vy=st.vy.at[0].set(0.0),
        vz=st.vz.at[0].set(0.0),
    )
    step = magnetized.make_step(cfg)
    st2, m = step(st)
    # it hit the wall but the IEAD total only counts in-range impacts
    iead = np.asarray(st2.iead)
    n_in_range = iead.sum()
    assert int(m.n_hit_wall) >= 1
    # top energy bin not inflated by the out-of-range impact
    assert iead[0, -1, :].sum() == 0.0


def test_run_from_iead_matches_expanded_list():
    """The histogram-driven channel (pygcpic.py:1299-1300) is the per-impact
    channel evaluated at bin centers with histogram multiplicities."""
    model = bca.BinaryCollisionModel(seed=7)
    ne, na = 4, 3
    iead = np.zeros((ne, na))
    iead[3, 0] = 50   # 50 impacts at high energy, normal incidence
    iead[1, 2] = 20
    e_edges = np.linspace(0.0, 400.0, ne + 1)
    a_edges = np.linspace(0.0, 90.0, na + 1)
    s, r = model.run_from_iead(e_edges, a_edges, iead)
    s2, r2 = bca.BinaryCollisionModel(seed=7).run(
        np.concatenate([np.full(50, 350.0), np.full(20, 150.0)]),
        np.concatenate([np.full(50, 15.0), np.full(20, 75.0)]),
    )
    # same RNG seed + same reconstructed impact list -> identical products
    np.testing.assert_allclose(s, s2)
    np.testing.assert_allclose(r, r2)
    # null interface stays empty
    s0, r0 = bca.NullBCA().run_from_iead(e_edges, a_edges, iead)
    assert s0.shape == (0, 6) and r0.shape == (0, 6)


def test_postprocess_iead_budget():
    """pic_iead parity: a short magnetized run's accumulated IEADs feed the
    end-of-run BCA post-process and the deposited/reflected/sputtered budget
    balances (pygcpic.py:1301-1305)."""
    from pypic_tpu import presets as presets_mod
    from pypic_tpu.runner import run as run_steps

    pre = presets_mod.pic_iead(n_per_species=400)
    step = pre.make_step()
    fin, _ = run_steps(step, pre.state, 150)
    iead = np.asarray(fin.iead)
    assert iead.sum() > 0  # impacts accumulated
    stats = bca.postprocess_iead(
        iead, pre.config.iead_energy_max, pre.config.iead_angle_max,
        bca.BinaryCollisionModel(incident_m_amu=2.0, incident_z=1, seed=1),
        bca.BinaryCollisionModel(incident_m_amu=10.81, incident_z=5, seed=2),
    )
    assert stats["num_incident_source"] == iead[0].sum()
    assert stats["num_incident_wall"] == iead[1].sum()
    assert (stats["num_deposited_wall"] + stats["num_reflected_wall"]
            == stats["num_incident_wall"])
    assert stats["num_sputtered"] >= 0
    # product rows honor the row contract
    for rows in (stats["source_sputtered"], stats["wall_reflected"]):
        assert rows.ndim == 2 and rows.shape[1] == 6


def test_bca_driver_batched_cadence():
    """pic_steps_per_bca batches k jitted steps per surface-model call; the
    physics channel stays live (impacts collected from every step of the
    block, products injected at block boundaries)."""
    cfg, st, pre = _bca_setup(ppc=10)
    model_sw = bca.BinaryCollisionModel(seed=1)
    model_ww = bca.BinaryCollisionModel(incident_m_amu=10.81, incident_z=5,
                                        seed=2)
    fin, stats, hist = bca_driver.run_bca(
        st, cfg, 120, model_sw, model_ww,
        product_p2c=float(np.asarray(st.p2c)[0]), seed=3,
        pic_steps_per_bca=10,
    )
    assert len(hist) == 120  # per-step metrics preserved
    assert stats.source_incident > 100
    assert stats.sputtered > 0 and stats.injected > 0
    assert 0.0 < stats.total_yield() < 0.5


def test_bca_iead_channel_full_chain():
    """run_bca_from_iead: the histogram channel (pygcpic.py:1299-1300) drives
    the same surface physics as the list channel — impacts accumulate in the
    in-state IEADs, each block's increment feeds run_from_iead, and products
    inject as neutral wall atoms."""
    cfg, st, pre = _bca_setup(ppc=10)
    cfg = dataclasses.replace(cfg, impact_buffer_size=0)
    model_sw = bca.BinaryCollisionModel(seed=1)
    model_ww = bca.BinaryCollisionModel(incident_m_amu=10.81, incident_z=5,
                                        seed=2)
    fin, stats, hist = bca_driver.run_bca_from_iead(
        st, cfg, 120, model_sw, model_ww,
        product_p2c=float(np.asarray(st.p2c)[0]), seed=3,
        pic_steps_per_bca=10,
    )
    assert len(hist) == 120
    assert stats.source_incident > 100
    assert stats.sputtered > 0 and stats.injected > 0
    assert stats.dropped == 0
    act = np.asarray(fin.active) == 1
    assert (np.asarray(fin.from_wall)[act] == 1).sum() > 0
    assert 0.0 < stats.total_yield() < 0.5


def test_bca_iead_channel_survives_f32_saturation():
    """A bin holding 2^24 f32 counts no longer freezes the histogram
    channel: the driver drains the device IEAD every BCA round into an f64
    host total, so increments never ride on top of a saturated f32 value
    (the old total-minus-seen delta was silently zero forever there)."""
    cfg, st, pre = _bca_setup(ppc=10)
    cfg = dataclasses.replace(cfg, impact_buffer_size=0)
    sat = np.zeros(np.asarray(st.iead).shape, np.float32)
    sat[:] = 2.0 ** 24  # every bin saturated: f32 x + 1.0 == x
    st = st.replace(iead=jnp.asarray(sat))
    fin, stats, _ = bca_driver.run_bca_from_iead(
        st, cfg, 60, bca.BinaryCollisionModel(seed=1),
        bca.BinaryCollisionModel(incident_m_amu=10.81, incident_z=5, seed=2),
        product_p2c=float(np.asarray(st.p2c)[0]), seed=3,
        pic_steps_per_bca=10,
    )
    # the old total-minus-seen delta was identically zero here (f32
    # x + 1 == x at 2^24) — the channel saw no flux and injected nothing
    assert stats.source_incident > 50
    assert stats.injected > 0
    # the returned state still carries the running total (f32-rounded per
    # bin, spacing 2 at 2^24 — never LESS than the saturated baseline)
    assert np.asarray(fin.iead, np.float64).sum() >= sat.sum() - sat.size


def test_bca_iead_dp_matches_single_device():
    """The IEAD channel is mesh-capable: psum'd histograms are replicated, so
    an 8-shard data-parallel hybrid run feeds the surface model the same
    global wall flux as the single-device run (VERDICT round-2 item 3)."""
    from pypic_tpu.parallel import make_mesh, make_data_parallel_step
    from pypic_tpu.parallel.dataparallel import shard_state

    pre = presets.pic_bca_aps(ppc=4)
    # impact buffer off (dp gate); ionization off (per-shard folded keys
    # draw different — equally valid — randoms than the 1-device stream)
    cfg1 = dataclasses.replace(pre.config, impact_buffer_size=0,
                               ionization=False)

    def models():
        return (bca.BinaryCollisionModel(seed=1),
                bca.BinaryCollisionModel(incident_m_amu=10.81, incident_z=5,
                                         seed=2))

    m_sw, m_ww = models()
    fin1, stats1, _ = bca_driver.run_bca_from_iead(
        pre.state, cfg1, 40, m_sw, m_ww, seed=3, pic_steps_per_bca=5,
    )

    mesh = make_mesh(8)
    cfg8 = dataclasses.replace(cfg1, axis_name="particles")
    step8 = make_data_parallel_step(
        magnetized.make_step, cfg8, mesh, example_state=pre.state
    )
    m_sw8, m_ww8 = models()
    fin8, stats8, _ = bca_driver.run_bca_from_iead(
        shard_state(pre.state, mesh), cfg8, 40, m_sw8, m_ww8, seed=3,
        pic_steps_per_bca=5, step_fn=step8,
        reshard=lambda s: shard_state(s, mesh),
    )
    assert stats1.source_incident > 0 and stats1.injected > 0
    # borderline wall impacts flip under f32 psum ordering; the channels
    # otherwise see identical (replicated) histograms
    tol = max(6, 0.05 * stats1.source_incident)
    assert abs(stats1.source_incident - stats8.source_incident) <= tol
    assert abs(stats1.injected - stats8.injected) <= max(
        6, 0.15 * stats1.injected
    )
    assert int(np.asarray(fin8.p).shape[0]) == int(np.asarray(fin1.p).shape[0])


def test_ftridyn_seam_fixture_contract():
    """bca.FTridynBCA against a recorded fake ``fractal_tridyn`` module:
    pins the exact constructor/call/file contract the reference uses
    (pygcpic.py:1389-1390 constructor symbols; 1571-1572
    run_tridyn_simulations_from_list(energies, angles, number_histories=N);
    1299-1300 run_tridyn_simulations_from_iead(energy_range, angle_range,
    iead, number_histories=N); products thinned by [::number_histories]
    into 6-field (energy, ca, cb, cg, m, Z) rows consumed by
    particle_from_energy_angle_coordinates, pygcpic.py:35-68) — so the
    seam stays testable without the external Fortran package."""
    import sys
    import types

    calls = {}

    class _FakeInterface:
        def __init__(self, source, wall):
            calls["ctor"] = (source, wall)

        def run_tridyn_simulations_from_list(self, energies, angles,
                                             number_histories=100):
            calls["from_list"] = (energies, angles, number_histories)
            assert isinstance(energies, list) and isinstance(angles, list)
            assert len(energies) == len(angles)
            # the real package returns number_histories rows PER incident
            # particle: [energy, ca, cb, cg, m, Z] each
            row_s = [8.5, 0.9, 0.3, 0.3, 196.97, 79]
            row_r = [40.0, 0.8, 0.4, 0.4, 2.014, 1]
            sput = [list(row_s) for _ in range(2 * number_histories)]
            refl = [list(row_r)
                    for _ in range(len(energies) * number_histories)]
            return sput, refl

        def run_tridyn_simulations_from_iead(self, energy_edges, angle_edges,
                                             iead, number_histories=100):
            calls["from_iead"] = (np.asarray(energy_edges),
                                  np.asarray(angle_edges),
                                  np.asarray(iead), number_histories)
            row = [8.5, 0.9, 0.3, 0.3, 196.97, 79]
            return ([list(row) for _ in range(3 * number_histories)],
                    [list(row) for _ in range(number_histories)])

    pkg = types.ModuleType("fractal_tridyn")
    utils = types.ModuleType("fractal_tridyn.utils")
    gen = types.ModuleType("fractal_tridyn.utils.generate_ftridyn_input")
    gen.tridyn_interface = _FakeInterface
    pkg.utils = utils
    utils.generate_ftridyn_input = gen
    saved = {k: sys.modules.get(k) for k in
             ("fractal_tridyn", "fractal_tridyn.utils",
              "fractal_tridyn.utils.generate_ftridyn_input")}
    sys.modules["fractal_tridyn"] = pkg
    sys.modules["fractal_tridyn.utils"] = utils
    sys.modules["fractal_tridyn.utils.generate_ftridyn_input"] = gen
    try:
        iface = bca.FTridynBCA("He", "Au")
        assert calls["ctor"] == ("He", "Au")

        sput, refl = iface.run(np.array([30.0, 55.0, 80.0]),
                               np.array([10.0, 45.0, 60.0]),
                               num_histories=50)
        energies, angles, nh = calls["from_list"]
        assert energies == [30.0, 55.0, 80.0] and nh == 50
        # [::number_histories] thinning -> one row per simulated history
        # batch, 6 fields each
        assert sput.shape == (2, 6) and refl.shape == (3, 6)
        assert sput.dtype == np.float64
        np.testing.assert_allclose(sput[0], [8.5, 0.9, 0.3, 0.3, 196.97, 79])

        ne, na = 5, 4
        iead = np.zeros((ne, na))
        iead[2, 1] = 7.0
        e_edges = np.linspace(0.0, 100.0, ne + 1)
        a_edges = np.linspace(0.0, 90.0, na + 1)
        sput, refl = iface.run_from_iead(e_edges, a_edges, iead,
                                         num_histories=25)
        ee, aa, hist, nh = calls["from_iead"]
        np.testing.assert_array_equal(ee, e_edges)
        np.testing.assert_array_equal(aa, a_edges)
        np.testing.assert_array_equal(hist, iead)
        assert nh == 25
        assert sput.shape == (3, 6) and refl.shape == (1, 6)
    finally:
        for k, v in saved.items():
            if v is None:
                del sys.modules[k]
            else:
                sys.modules[k] = v
