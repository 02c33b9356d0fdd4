"""Hybrid PIC <-> surface-model driver (the pic_bca_aps loop).

The surface coupling is the reference's only process boundary
(SURVEY.md §3.4: the F-TRIDYN Fortran binary runs between PIC steps,
pygcpic.py:1571-1572). The rebuild keeps that structure: the magnetized
engine's step is jitted; each driver iteration fetches the step's wall-impact
rows to the host, runs the BCA model per (incident-species -> wall) channel,
and injects sputtered + reflected products back into free particle slots
(pygcpic.py:1599-1625), with periodic checkpointing (pygcpic.py:1627-1632)
and yield/reflection statistics (pygcpic.py:1468-1480).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .. import bca as bca_mod
from .. import checkpoint as ckpt_mod
from . import magnetized


@dataclasses.dataclass
class BCAStats:
    """Per-run accumulated surface statistics (pygcpic.py:1408-1418)."""

    source_incident: int = 0
    wall_incident: int = 0
    sputtered: int = 0
    self_sputtered: int = 0
    source_sputtered: int = 0
    source_reflected: int = 0
    wall_reflected: int = 0
    injected: int = 0
    dropped: int = 0
    # wall-species impacts that were themselves wall-born (BCA products
    # landing back on the wall — pic_bca_aps's per-step `redeposited`
    # counter, pygcpic.py:1521-1522); counted under write_particles
    redeposited: int = 0
    # sheath-escape events whose .dat line was dropped by the per-step
    # row buffer cap (dynamics unaffected; write_particles only)
    escape_lines_dropped: int = 0

    def total_yield(self) -> float:
        inc = self.source_incident + self.wall_incident
        return self.sputtered / inc if inc else 0.0

    def source_reflection(self) -> float:
        return (
            self.source_reflected / self.source_incident
            if self.source_incident
            else 0.0
        )


@jax.jit
def _pack(ms):
    # one flat device array -> ONE host transfer per block instead of
    # ~15 leaf fetches, each paying a device-to-host round trip (all metric
    # values are f32-exact: counts < 2^24, data already f32)
    return jnp.concatenate(
        [jnp.ravel(l).astype(jnp.float32) for l in jax.tree.leaves(ms)]
    )


def _fetch(ms):
    leaves, treedef = jax.tree.flatten(ms)
    flat = np.asarray(_pack(ms))
    out, o = [], 0
    for l in leaves:
        n_ = int(np.prod(l.shape)) if l.shape else 1
        out.append(flat[o:o + n_].reshape(l.shape).astype(l.dtype))
        o += n_
    return jax.tree.unflatten(treedef, out)


def run_bca(
    state: magnetized.MagnetizedState,
    cfg: magnetized.MagnetizedConfig,
    steps: int,
    bca_source_wall: bca_mod.BCAInterface,
    bca_wall_wall: bca_mod.BCAInterface,
    *,
    source_species_idx: int = 0,
    wall_species_idx: int = 1,
    product_p2c: Optional[float] = None,
    num_histories: int = 100,
    checkpoint_manager: Optional[ckpt_mod.CheckpointManager] = None,
    seed: int = 0,
    log_every: int = 0,
    pic_steps_per_bca: int = 1,
    write_particles: Optional[str] = None,
):
    """Run the hybrid loop for ``steps`` steps.

    Requires cfg.impact_buffer_size > 0 (wall-impact extraction on).

    ``write_particles`` (a directory) streams the reference's per-event
    .dat files (pygcpic.py:1440-1447, 1516-1541): one vx/vth line per
    wall impact into ``source_wall.dat`` / ``wall_wall.dat`` (split by
    incident species), ``lateral_displacements.dat`` with the wall
    species' sqrt(y^2+z^2), and one vx/vth line per mid-domain sheath
    escape into ``source_out.dat`` / ``wall_out.dat`` (needs
    cfg.bca_escape for any escape events to exist).

    ``pic_steps_per_bca`` batches k jitted PIC steps per host round-trip
    (one lax.scan dispatch), accumulating each step's wall-impact rows and
    running the surface model once per block — the natural cadence knob the
    reference lacks (it calls F-TRIDYN every step, pygcpic.py:1571-1572;
    k=1 reproduces that). Products are injected at block boundaries, so at
    k>1 sputtered/reflected atoms re-enter up to k-1 steps later than the
    reference's cadence.

    Returns:
        (final_state, BCAStats, metrics_list) — metrics_list holds the
        per-step StepMetrics pytrees (host numpy).
    """
    if cfg.impact_buffer_size <= 0:
        raise ValueError("cfg.impact_buffer_size must be > 0 for BCA runs")
    if pic_steps_per_bca < 1:
        raise ValueError("pic_steps_per_bca must be >= 1")
    from ..runner import run as run_scan

    step_raw = magnetized.make_step(cfg)
    inject = magnetized.make_inject(cfg)
    rng = np.random.default_rng(seed)
    stats = BCAStats()
    if product_p2c is None:
        product_p2c = float(np.asarray(state.p2c)[0])
    z_to_idx: Dict[int, int] = {z: i for i, z in enumerate(cfg.species_z)}
    metrics_hist = []

    done = 0
    while done < steps:
        k_steps = min(pic_steps_per_bca, steps - done)
        state, ms = run_scan(step_raw, state, k_steps)
        ms = _fetch(ms)  # leaves stacked (k_steps, ...), host numpy
        it = done + k_steps - 1
        done += k_steps
        metrics = jax.tree.map(lambda a: a[-1], ms)
        metrics_hist.extend(
            jax.tree.map(lambda a, i=i: a[i], ms) for i in range(k_steps)
        )
        # valid impact rows from every step of the block (pygcpic.py:1516-1527)
        impacts = np.concatenate([
            ms.impacts[i, : int(ms.n_impacts[i])] for i in range(k_steps)
        ])
        n_imp = impacts.shape[0]

        if write_particles is not None:
            # reference write_particles event streams (pygcpic.py:1440-1447,
            # 1516-1541): one line per event, append-per-block
            esc = np.concatenate([
                ms.escapes[i, : int(ms.n_escape_rows[i])]
                for i in range(k_steps)
            ])
            src_hit = impacts[:, 2].astype(int) == source_species_idx
            wall_hit = impacts[:, 2].astype(int) == wall_species_idx
            _append_events(write_particles, "source_wall.dat",
                           impacts[src_hit, 4])
            _append_events(write_particles, "wall_wall.dat",
                           impacts[wall_hit, 4])
            _append_events(write_particles, "lateral_displacements.dat",
                           impacts[wall_hit, 5])
            src_out = esc[:, 1].astype(int) == source_species_idx
            wall_out = esc[:, 1].astype(int) == wall_species_idx
            _append_events(write_particles, "source_out.dat",
                           esc[src_out, 0])
            _append_events(write_particles, "wall_out.dat", esc[wall_out, 0])
            stats.redeposited += int(impacts[wall_hit, 6].sum())
            # escapes past the per-step buffer cap lose their event LINE
            # (never their dynamics — deactivation is exact); keep the
            # stream honest by counting what the .dat files are missing
            stats.escape_lines_dropped += max(
                0, int(np.asarray(ms.n_escaped).sum()) - esc.shape[0])

        # split impacts by incident species (pygcpic.py:1517-1527)
        rows_by_channel = {}
        for name, sp_idx, iface in (
            ("source", source_species_idx, bca_source_wall),
            ("wall", wall_species_idx, bca_wall_wall),
        ):
            sel = impacts[:, 2].astype(int) == sp_idx
            energies = impacts[sel, 0]
            angles = impacts[sel, 1]
            sides = impacts[sel, 3]
            rows_by_channel[name] = (energies, angles, sides, iface)
            if name == "source":
                stats.source_incident += int(sel.sum())
            else:
                stats.wall_incident += int(sel.sum())

        new_rows = []
        new_sides = []
        for name, (energies, angles, sides, iface) in rows_by_channel.items():
            if energies.size == 0:
                continue
            sput, refl = iface.run(energies, angles, num_histories=num_histories)
            stats.sputtered += len(sput)
            if name == "wall":
                stats.self_sputtered += len(sput)
                stats.wall_reflected += len(refl)
            else:
                stats.source_sputtered += len(sput)
                stats.source_reflected += len(refl)
            for rows in (sput, refl):
                if len(rows):
                    new_rows.append(np.asarray(rows))
                    # products leave from a random wall in the reference
                    # (pygcpic.py:1607); physically they come from the wall
                    # that was struck — keep the reference behavior
                    new_sides.append(
                        rng.integers(0, 2, len(rows)).astype(np.float64)
                    )

        if new_rows:
            rows = np.concatenate(new_rows)
            sides = np.concatenate(new_sides)
            batch = bca_mod.particles_from_energy_angle(
                rows, sides, cfg.dt, cfg.grid.length, product_p2c, rng
            )
            k = len(batch["x"])
            sp_idx = np.asarray(
                [z_to_idx.get(int(z), wall_species_idx) for z in batch["z"]],
                np.int32,
            )
            if write_particles is not None:
                # BCA products' launch vx/vth at injection — the
                # {source,wall}_from_wall.dat streams (pygcpic.py:1607-1621)
                from ..constants import K_BOLTZMANN

                t_samp = (cfg.source.ti if cfg.source is not None
                          else cfg.te)
                vx_b = (np.asarray(batch["v"])[:, 0]
                        / np.sqrt(K_BOLTZMANN * t_samp
                                  / np.asarray(batch["m"], np.float64)))
                _append_events(write_particles, "wall_from_wall.dat",
                               vx_b[sp_idx == wall_species_idx])
                _append_events(write_particles, "source_from_wall.dat",
                               vx_b[sp_idx == source_species_idx])
            t_now = np.full(k, (it + 1) * cfg.dt, np.float32)
            # pad the product batch to a power-of-2 bucket: the jitted inject
            # would otherwise recompile for every distinct batch size (a
            # compile per call would dominate the hybrid loop)
            bucket = max(8, 1 << (k - 1).bit_length())
            pad = bucket - k

            def padded(a, dt_):
                a = np.asarray(a, dt_)
                return np.concatenate(
                    [a, np.zeros((pad,) + a.shape[1:], dt_)]
                )

            state, n_inj, n_drop = inject(
                state,
                padded(batch["x"], np.float32),
                padded(batch["yz"], np.float32),
                padded(batch["v"], np.float32),
                padded(batch["m"], np.float32),
                padded(batch["charge_state"], np.float32),
                padded(batch["p2c"], np.float32),
                padded(sp_idx, np.int32),
                padded(t_now, np.float32),
                np.concatenate([np.ones(k, bool), np.zeros(pad, bool)]),
            )
            n_inj, n_drop = np.asarray(jnp.stack([n_inj, n_drop]))  # 1 fetch
            stats.injected += int(n_inj)
            stats.dropped += int(n_drop)

        if checkpoint_manager is not None:
            checkpoint_manager.maybe_save(state, done)

        if log_every and (it % log_every < k_steps):
            print(
                f"step {it}: active {int(metrics.n_active)}, impacts {n_imp}, "
                f"yield {stats.total_yield():.3f}, "
                f"{cfg_species_name(cfg, source_species_idx)} reflection "
                f"{stats.source_reflection():.3f}"
            )

    return state, stats, metrics_hist


def cfg_species_name(cfg, idx):
    return f"Z={cfg.species_z[idx]}"


def _append_events(dirpath: str, name: str, values) -> None:
    """Append one line per value to a write_particles .dat stream
    (pygcpic.py print(..., file=f, flush=True) format)."""
    import os

    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, name), "a") as f:
        f.writelines(f"{v}\n" for v in np.asarray(values))


def run_bca_from_iead(
    state: magnetized.MagnetizedState,
    cfg: magnetized.MagnetizedConfig,
    steps: int,
    bca_source_wall: bca_mod.BCAInterface,
    bca_wall_wall: bca_mod.BCAInterface,
    *,
    source_species_idx: int = 0,
    wall_species_idx: int = 1,
    product_p2c: Optional[float] = None,
    num_histories: int = 100,
    checkpoint_manager: Optional[ckpt_mod.CheckpointManager] = None,
    seed: int = 0,
    log_every: int = 0,
    pic_steps_per_bca: int = 1,
    step_fn=None,
    reshard=None,
):
    """Hybrid loop on the HISTOGRAM channel — the mesh-capable form of
    ``run_bca``.

    Instead of per-impact (E, theta) rows (cfg.impact_buffer_size, a
    host-hybrid seam gated off under data-parallel sharding), each block
    feeds the *increment* of the in-state per-species IEAD histograms
    through ``run_from_iead`` (the reference's own histogram channel,
    ``run_tridyn_simulations_from_iead``, pygcpic.py:1299-1300) and injects
    the sputtered/reflected products into free slots. The IEADs are psum'd
    and replicated under dp (engines.magnetized._iead_accumulate), so the
    surface coupling sees the GLOBAL wall flux on every mesh layout —
    single-device and 8-way data-parallel runs drive identical BCA inputs
    (equivalence-tested on the virtual mesh).

    Differences vs the list channel (both inherited from the reference's
    histogram path): impacts are reconstructed at bin centers, and impacts
    outside the histogram range [0, iead_energy_max] x [0, iead_angle_max]
    are not seen by the surface model (np.histogram2d range semantics,
    pygcpic.py:1259).

    Args:
        step_fn: optional prebuilt step (e.g. the shard_mapped dp step from
            parallel.make_data_parallel_step); defaults to the single-device
            ``magnetized.make_step(cfg)``.
        reshard: optional callable state -> state re-placing the injected
            state on the mesh (e.g. ``lambda s: dataparallel.shard_state(s,
            mesh)``); the jitted injector's output sharding need not match
            the shard_map step's expectation otherwise.

    Returns:
        (final_state, BCAStats, metrics_list) like ``run_bca``.
    """
    if cfg.iead_energy_max <= 0.0:
        raise ValueError(
            "cfg.iead_energy_max must be > 0 (IEAD accumulation drives the "
            "histogram channel)"
        )
    if pic_steps_per_bca < 1:
        raise ValueError("pic_steps_per_bca must be >= 1")
    from ..runner import run as run_scan

    step_raw = magnetized.make_step(cfg) if step_fn is None else step_fn
    inject = magnetized.make_inject(cfg)
    rng = np.random.default_rng(seed)
    stats = BCAStats()
    if product_p2c is None:
        product_p2c = float(np.asarray(state.p2c)[0])
    z_to_idx: Dict[int, int] = {z: i for i, z in enumerate(cfg.species_z)}
    metrics_hist = []

    ne, na = cfg.iead_bins
    e_edges = np.linspace(0.0, cfg.iead_energy_max, ne + 1)
    a_edges = np.linspace(0.0, cfg.iead_angle_max, na + 1)
    # The engine accumulates iead in f32 (the engines' deposit dtype); a bin
    # saturates at 2^24 counts, after which `total - seen` deltas are
    # silently zero and the surface model stops seeing wall flux. Drain
    # the device histogram every BCA round into an f64 HOST total instead:
    # per-round bin counts stay far below the f32 integer range, and the
    # checkpointed/returned state carries the (f32-rounded) running total.
    iead_total = np.asarray(state.iead, np.float64).copy()

    def _drained(st):
        st = st.replace(iead=jnp.zeros_like(st.iead))
        return reshard(st) if reshard is not None else st

    def _with_total(st):
        return st.replace(iead=jnp.asarray(iead_total, st.iead.dtype))

    state = _drained(state)

    done = 0
    while done < steps:
        k_steps = min(pic_steps_per_bca, steps - done)
        state, ms = run_scan(step_raw, state, k_steps)
        ms = _fetch(ms)  # leaves stacked (k_steps, ...), host numpy
        it = done + k_steps - 1
        done += k_steps
        metrics = jax.tree.map(lambda a: a[-1], ms)
        metrics_hist.extend(
            jax.tree.map(lambda a, i=i: a[i], ms) for i in range(k_steps)
        )
        delta = np.asarray(state.iead, np.float64)
        iead_total += delta
        state = _drained(state)

        new_rows = []
        new_sides = []
        for name, sp_idx, iface in (
            ("source", source_species_idx, bca_source_wall),
            ("wall", wall_species_idx, bca_wall_wall),
        ):
            d = delta[sp_idx]
            n_inc = int(round(d.sum()))
            if name == "source":
                stats.source_incident += n_inc
            else:
                stats.wall_incident += n_inc
            if n_inc == 0:
                continue
            sput, refl = iface.run_from_iead(
                e_edges, a_edges, d, num_histories=num_histories
            )
            stats.sputtered += len(sput)
            if name == "wall":
                stats.self_sputtered += len(sput)
                stats.wall_reflected += len(refl)
            else:
                stats.source_sputtered += len(sput)
                stats.source_reflected += len(refl)
            for rows in (sput, refl):
                if len(rows):
                    new_rows.append(np.asarray(rows))
                    new_sides.append(
                        rng.integers(0, 2, len(rows)).astype(np.float64)
                    )

        if new_rows:
            rows = np.concatenate(new_rows)
            sides = np.concatenate(new_sides)
            batch = bca_mod.particles_from_energy_angle(
                rows, sides, cfg.dt, cfg.grid.length, product_p2c, rng
            )
            k = len(batch["x"])
            sp_idx_arr = np.asarray(
                [z_to_idx.get(int(z), wall_species_idx) for z in batch["z"]],
                np.int32,
            )
            t_now = np.full(k, (it + 1) * cfg.dt, np.float32)
            bucket = max(8, 1 << (k - 1).bit_length())
            pad = bucket - k

            def padded(a, dt_):
                a = np.asarray(a, dt_)
                return np.concatenate(
                    [a, np.zeros((pad,) + a.shape[1:], dt_)]
                )

            state, n_inj, n_drop = inject(
                state,
                padded(batch["x"], np.float32),
                padded(batch["yz"], np.float32),
                padded(batch["v"], np.float32),
                padded(batch["m"], np.float32),
                padded(batch["charge_state"], np.float32),
                padded(batch["p2c"], np.float32),
                padded(sp_idx_arr, np.int32),
                padded(t_now, np.float32),
                np.concatenate([np.ones(k, bool), np.zeros(pad, bool)]),
            )
            n_inj, n_drop = np.asarray(jnp.stack([n_inj, n_drop]))
            stats.injected += int(n_inj)
            stats.dropped += int(n_drop)
            if reshard is not None:
                state = reshard(state)

        if checkpoint_manager is not None:
            # checkpoints carry the running total (resume re-drains it)
            checkpoint_manager.maybe_save(_with_total(state), done)

        if log_every and (it % log_every < k_steps):
            print(
                f"step {it}: active {int(metrics.n_active)}, "
                f"yield {stats.total_yield():.3f}, "
                f"{cfg_species_name(cfg, source_species_idx)} reflection "
                f"{stats.source_reflection():.3f}"
            )

    state = _with_total(state)
    if reshard is not None:
        state = reshard(state)
    return state, stats, metrics_hist
