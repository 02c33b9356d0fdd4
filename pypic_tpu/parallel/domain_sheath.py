"""Domain-decomposed bounded sheath engine (absorbing walls on end shards).

Composes the gen-2 Dirichlet-Dirichlet sheath cycle (PIC_L_DD.py:316-644,
rebuilt in ``pypic_tpu.engines.sheath``) with the slab machinery of
``pypic_tpu.parallel.domain`` — the BASELINE.json configs[4] "PIC_L_DD
sharded across a mesh" workload:

* the bounded grid is slab-sharded over a *chain* (no ring wrap): halo
  ``ppermute`` pairs omit the wrap link, so end shards receive zero halos —
  the physical walls;
* **absorbing walls live on the end shards**: the wall surface-charge
  currents ``j[0] += dx q p2c / dt`` per left-absorbed particle
  (PIC_L_DD.py:55-63) are psum-reduced charge sums applied on shard 0 /
  shard D-1 only, as is the edge fold ``j[0] += j[1]; j[-1] += j[-2]``
  (PIC_L_DD.py:65-66);
* the Ampere advance ``E1 = E0 + (dt/eps0)(<jh> - jh)`` (PIC_L_DD.py:516)
  is local up to the psum'd mean, so E and j stay slab-sharded through the
  Picard loop exactly as in ``domain_implicit``;
* **re-injection targets the owner shard**: absorbed particles draw a fresh
  uniform position over the *global* domain (PIC_L_DD.py:429-450) and are
  multi-hop migrated to the owning slab before the Picard loop; a second
  migration after the push returns boundary-crossing survivors to their
  owners. Absorbed-but-not-yet-reinjected particles are parked mid-slab so
  they stay put (their state is dead until re-injection, matching the
  reference's zeroed absorbed state, PIC_L_DD.py:459-467);
* per-particle q/m/species/status ride the migration buffers, so the
  two-species (me vs mp, PIC_L_DD.py:235-241) 1d3v structure is preserved.

The potential diagnostic (cumulative -trapz of E, PIC_L_DD.py:518-523) is
the one O(ng) all_gather per step — it is a diagnostic, not a solve.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..utils.pytree import PyTreeNode
from ..constants import EPSILON_0
from ..engines.sheath import ACTIVE, LOST_LEFT, LOST_RIGHT
from ..grid import GridSpec
from ..ops import deposit, gather, histogram_add, integrate_neg_trapz
from .domain import distribute_by_slab, halo_extend, halo_fold, migrate, ring_perms

shard_map = jax.shard_map


@dataclasses.dataclass(frozen=True)
class DomainSheathConfig:
    grid: GridSpec  # bc='dirichlet-dirichlet'; ng must divide by num_shards
    dt: float
    p2c: float
    kbte: float
    kbti: float
    num_shards: int
    tol: float = 1e-5  # PIC_L_DD.py:317
    # f32 residual-floor exit in units of eps_f32 * global ||es||_2 — see
    # engines.sheath.SheathConfig.tol_floor (the reference's absolute
    # tolerance is unattainable in f32 at sheath field magnitudes and the
    # loop grinds round-off to maxiter without it); 0 restores the
    # pure-absolute test. The norm is psum'd over the slab axis.
    tol_floor: float = 0.5
    maxiter: int = 20  # PIC_L_DD.py:318
    gamma: float = 0.0  # thermostat probability (PIC_L_DD.py:331)
    halo: int = 2  # max intra-step excursion, cells
    migrate_cap: int = 4096
    axis_name: str = "slabs"
    deposit_method: str = "auto"
    exit_hist_bins: int = 64
    exit_hist_vmax: float = 0.0
    record_exit_after_step: int = 2000  # PIC_L_DD.py:497
    # Picard iterate start + mixing — see engines.sheath.SheathConfig: the
    # bounded sheath's plain loop takes ~13-17 iterations; Anderson(1)
    # mixing (psum'd inner products here, fields are slab-sharded) cuts it
    # to ~8 at the same fixed point/tolerance.
    picard_init: str = "field"
    picard_accel: str = "none"

    def __post_init__(self):
        for f in ("dt", "p2c", "kbte", "kbti", "tol", "tol_floor", "gamma",
                  "exit_hist_vmax"):
            object.__setattr__(self, f, float(getattr(self, f)))
        for f in ("maxiter", "halo", "migrate_cap", "num_shards",
                  "exit_hist_bins", "record_exit_after_step"):
            object.__setattr__(self, f, int(getattr(self, f)))
        if self.grid.ng % self.num_shards:
            raise ValueError(
                f"ng={self.grid.ng} not divisible by {self.num_shards} shards"
            )
        if self.halo + 3 > self.cells_per_shard:
            raise ValueError(
                f"halo={self.halo} too large for {self.cells_per_shard}-cell "
                "slabs (need halo + 3 <= cells_per_shard)"
            )
        if self.picard_init not in ("field", "extrapolate"):
            raise ValueError(f"unknown picard_init {self.picard_init!r}")
        if self.picard_accel not in ("none", "anderson", "anderson2"):
            raise ValueError(f"unknown picard_accel {self.picard_accel!r}")

    @property
    def cells_per_shard(self) -> int:
        return self.grid.ng // self.num_shards


class DomainSheathState(PyTreeNode):
    p: jax.Array  # (S*cap,) global grid coords, sharded
    v: jax.Array  # (S*cap, 3) [m/s], sharded
    q: jax.Array  # (S*cap,) [C], sharded
    m: jax.Array  # (S*cap,) [kg], sharded
    species: jax.Array  # (S*cap,) int32 (1 e-, 2 ion), sharded
    active: jax.Array  # (S*cap,) int32 in {1, 0, -1}, sharded
    filled: jax.Array  # (S*cap,) bool slot occupancy, sharded
    e: jax.Array  # (ng,) [V/m], slab-sharded
    j: jax.Array  # (ng,) [A/m^2], slab-sharded
    e_prev: jax.Array  # (ng,) previous-step field, slab-sharded
    rng: jax.Array  # PRNG key, replicated
    exit_hist: jax.Array  # (2, bins), replicated
    step: jax.Array  # () int32


class StepMetrics(NamedTuple):
    field_energy: jax.Array
    kinetic_energy: jax.Array
    current_bias: jax.Array
    picard_iters: jax.Array
    picard_residual: jax.Array
    n_active: jax.Array
    n_lost_left: jax.Array
    n_lost_right: jax.Array
    n_migrated: jax.Array
    n_dropped: jax.Array
    n_halo_clamped: jax.Array  # final-iterate excursions beyond the halo
    phi: jax.Array  # (ng,) replicated diagnostic


def init_state(
    x, v3, q, m, species, cfg: DomainSheathConfig, seed: int = 0,
    capacity_factor: float = 1.5,
) -> DomainSheathState:
    """Slab-distribute initializer output; initial j0 from the loaded
    particles (PIC_L_DD.py:385-389 — E0 starts at zero, preserved)."""
    grid = cfg.grid
    ng = grid.ng
    p = np.asarray(x) / grid.dx
    w = np.asarray(q) * (cfg.p2c / grid.dx)
    j0 = deposit(
        jnp.asarray(p, jnp.float32), jnp.asarray(w * np.asarray(v3)[:, 0],
                                                 jnp.float32),
        ng, periodic=False, method="scatter",
    )
    (p_o, v_o, q_o, m_o, s_o), filled, _ = distribute_by_slab(
        [p.astype(np.float32), np.asarray(v3, np.float32),
         np.asarray(q, np.float32), np.asarray(m, np.float32),
         np.asarray(species, np.int32)],
        x, cfg, capacity_factor,
    )
    n = filled.size
    return DomainSheathState(
        p=jnp.asarray(p_o.reshape(n)),
        v=jnp.asarray(v_o.reshape(n, 3)),
        q=jnp.asarray(q_o.reshape(n)),
        m=jnp.asarray(m_o.reshape(n)),
        species=jnp.asarray(s_o.reshape(n)),
        active=jnp.where(jnp.asarray(filled.reshape(n)), ACTIVE, LOST_RIGHT
                         ).astype(jnp.int32),
        filled=jnp.asarray(filled.reshape(n)),
        e=jnp.zeros((ng,), jnp.float32),
        j=j0.astype(jnp.float32),
        e_prev=jnp.zeros((ng,), jnp.float32),
        rng=jax.random.PRNGKey(seed),
        exit_hist=jnp.zeros((2, cfg.exit_hist_bins), jnp.float32),
        step=jnp.asarray(0, jnp.int32),
    )


def state_spec(cfg: DomainSheathConfig):
    ax = cfg.axis_name
    return DomainSheathState(
        p=P(ax), v=P(ax), q=P(ax), m=P(ax), species=P(ax), active=P(ax),
        filled=P(ax), e=P(ax), j=P(ax), e_prev=P(ax), rng=P(),
        exit_hist=P(), step=P(),
    )


def shard_state(state: DomainSheathState, mesh: Mesh, cfg: DomainSheathConfig):
    return jax.tree.map(
        lambda leaf, s: jax.device_put(
            leaf, jax.sharding.NamedSharding(mesh, s)
        ),
        state, state_spec(cfg),
    )


def make_step(cfg: DomainSheathConfig, mesh: Mesh):
    grid = cfg.grid
    ng = grid.ng
    dx = grid.dx
    dt = cfg.dt
    dt_dx = dt / dx
    cells = float(grid.num_cells)
    c = cfg.cells_per_shard
    d_tot = cfg.num_shards
    ax = cfg.axis_name
    h = cfg.halo
    hw = h + 1  # CIC right node; the sheath advance has no smoother
    ext_n = c + 2 * hw + 1
    perm_r, perm_l = ring_perms(d_tot, periodic=False)

    def clamp_loc(pl):
        return jnp.clip(pl, -float(h), float(c + h))

    def do_migrate(fields, filled, d):
        return migrate(
            fields, filled, d,
            ng=ng, cells_per_shard=c, num_shards=d_tot,
            cap=cfg.migrate_cap, ax=ax, periodic=False,
        )

    def local_step(state: DomainSheathState):
        d = lax.axis_index(ax)
        lo = d.astype(state.p.dtype) * c
        filled = state.filled

        key, k_therm_u, k_therm_v, k_reinj_x, k_reinj_v = jax.random.split(
            state.rng, 5
        )
        loc = lambda k: jax.random.fold_in(k, d)  # per-shard streams

        p_g, v0, active = state.p, state.v, state.active
        q, m, species = state.q, state.m, state.species
        e0 = state.e  # (c,) own slab

        # --- Thermostat (PIC_L_DD.py:420-427).
        if cfg.gamma > 0.0:
            hit = filled & (active == ACTIVE) & (
                jax.random.uniform(loc(k_therm_u), p_g.shape) < cfg.gamma
            )
            sig = jnp.sqrt(cfg.kbti / m)
            v_new = (jax.random.normal(loc(k_therm_v), v0.shape, v0.dtype)
                     * sig[:, None])
            v0 = jnp.where(hit[:, None], v_new, v0)

        # --- Re-injection (PIC_L_DD.py:429-450): fresh uniform position over
        # the GLOBAL domain + species-temperature Maxwellian; the owner shard
        # is reached by migration below.
        lost = filled & (active != ACTIVE)
        x_new = jax.random.uniform(loc(k_reinj_x), p_g.shape, p_g.dtype,
                                   0.0, cells)
        kbt_per = jnp.where(species == 1, cfg.kbte, cfg.kbti)
        v_new = (
            jax.random.normal(loc(k_reinj_v), v0.shape, v0.dtype)
            * jnp.sqrt(kbt_per / jnp.where(filled, m, 1.0))[:, None]
        )
        p_g = jnp.where(lost, x_new, p_g)
        v0 = jnp.where(lost[:, None], v_new, v0)

        (p_g, v0, q, m, species), filled, mig1, drop1 = do_migrate(
            [p_g, v0, q, m, species], filled, d
        )
        active = jnp.where(filled, ACTIVE, LOST_RIGHT).astype(jnp.int32)

        p0l = jnp.where(filled, p_g - lo, 0.0)
        u0 = jnp.where(filled, v0[:, 0], 0.0)
        qm = jnp.where(filled, q / jnp.where(filled, m, 1.0), 0.0)

        def _deposit_currents(pl, u, act):
            """Slab CIC deposit + psum'd wall surface-charge terms + edge
            fold on the end shards (PIC_L_DD.py:41-67)."""
            is_act = filled & (act == ACTIVE)
            w = jnp.where(is_act, q * (cfg.p2c / dx), 0.0)
            ext = deposit(
                clamp_loc(pl) + hw, w * u, ext_n,
                periodic=False, method=cfg.deposit_method,
            )
            jj = halo_fold(ext, c, hw, ax, perm_r, perm_l)
            wall = dx * cfg.p2c / dt
            jl = wall * lax.psum(
                jnp.sum(jnp.where(filled & (act == LOST_LEFT), q, 0.0)), ax
            )
            jr = -wall * lax.psum(
                jnp.sum(jnp.where(filled & (act == LOST_RIGHT), q, 0.0)), ax
            )
            jj = jj.at[0].add(jnp.where(d == 0, jl + jj[1], 0.0))
            jj = jj.at[c - 1].add(
                jnp.where(d == d_tot - 1, jr + jj[c - 2], 0.0)
            )
            return jj

        right_wall = cells - lo  # local coordinate of the right wall
        left_wall = 0.0 - lo

        from ..ops.accel import anderson2_mix, anderson_mix, mix_init

        accel = cfg.picard_accel

        def _mix(es, eh, k, aux):
            # fields are slab-sharded: the secant inner products psum
            if accel == "anderson":
                return anderson_mix(es, eh, k, aux, psum_axis=ax)
            if accel == "anderson2":
                return anderson2_mix(es, eh, k, aux, psum_axis=ax)
            return eh, aux

        es0 = (
            e0 + 0.5 * (e0 - state.e_prev)
            if cfg.picard_init == "extrapolate" else e0
        )

        # round-off floor of the WORKING dtype (f64 under x64, where the
        # reference's absolute tol is attainable — see engines.sheath)
        eps_w = float(jnp.finfo(es0.dtype).eps)

        def cond(carry):
            r, k = carry[-2], carry[-1]
            keep = r > cfg.tol
            if cfg.tol_floor > 0.0:
                es_n = jnp.sqrt(lax.psum(jnp.sum(carry[0] ** 2), ax))
                keep = keep & (r > (cfg.tol_floor * eps_w) * es_n)
            return keep & (k < cfg.maxiter)

        def body(carry):
            es, psl, _, _, act, hist, aux, _, k = carry
            is_act = filled & (act == ACTIVE)
            e_ext = halo_extend(es, hw, ax, perm_r, perm_l)
            e_p = jnp.where(
                is_act, gather(e_ext, clamp_loc(psl) + hw, periodic=False),
                0.0,
            )
            accel = qm * e_p
            x1 = p0l + dt_dx * u0 + (0.5 * dt * dt_dx) * accel
            u1 = u0 + dt * accel
            x1 = jnp.where(is_act, x1, 0.0)
            u1 = jnp.where(is_act, u1, 0.0)
            xh = jnp.where(is_act, 0.5 * (p0l + x1), 0.0)
            uh = jnp.where(is_act, 0.5 * (u0 + u1), 0.0)

            # Wall absorption on any of (x0, xh, x1) in local coordinates
            # (PIC_L_DD.py:493-505).
            right = is_act & (
                (p0l >= right_wall) | (xh >= right_wall) | (x1 >= right_wall)
            )
            left = is_act & (
                (p0l <= left_wall) | (xh <= left_wall) | (x1 <= left_wall)
            )
            act = jnp.where(right, LOST_RIGHT, act)
            act = jnp.where(left, LOST_LEFT, act)

            if cfg.exit_hist_vmax > 0.0:
                vout = jnp.where(right, u0, jnp.where(left, -u0, 0.0))
                rec = (right | left) & (
                    state.step >= cfg.record_exit_after_step
                )
                bins = cfg.exit_hist_bins
                idx = jnp.clip(
                    ((vout + cfg.exit_hist_vmax)
                     * (bins / (2.0 * cfg.exit_hist_vmax))).astype(jnp.int32),
                    0, bins - 1,
                )
                flat = jnp.clip(species - 1, 0, 1) * bins + idx
                upd = histogram_add(
                    flat, jnp.where(rec, 1.0, 0.0).astype(hist.dtype),
                    2 * bins, method=cfg.deposit_method,
                )
                hist = hist + upd.reshape(2, bins)

            jh = _deposit_currents(xh, uh, act)
            j1 = _deposit_currents(x1, u1, act)
            j_mean = lax.psum(jnp.sum(jh), ax) / ng
            e1 = e0 + (dt / EPSILON_0) * (j_mean - jh)
            eh = 0.5 * (e1 + e0)
            r = jnp.sqrt(lax.psum(jnp.sum((es - eh) ** 2), ax))
            es_next, aux = _mix(es, eh, k, aux)
            return es_next, xh, (x1, u1), (e1, j1), act, hist, aux, r, k + 1

        hist0 = jnp.zeros_like(state.exit_hist)
        carry0 = (
            es0, p0l, (p0l, u0), (e0, state.j), active, hist0,
            mix_init(e0, accel),
            jnp.asarray(jnp.inf, e0.dtype), jnp.asarray(0, jnp.int32),
        )
        _, _, (x1, u1), (e1, j1), active, hist_d, _, r, k = lax.while_loop(
            cond, body, carry0
        )

        is_act = filled & (active == ACTIVE)
        # halo-excursion accounting (detected, never silent — the grid ops
        # clamp to [-halo, c+halo], so an excursion past it deposited at the
        # clamp edge; size cfg.halo against dt * v_max / dx)
        n_halo_clamped = lax.psum(
            jnp.sum((is_act & ((x1 < -h) | (x1 > c + h))).astype(jnp.int32)),
            ax,
        )
        v1 = jnp.where(
            is_act[:, None],
            jnp.stack([u1, v0[:, 1], v0[:, 2]], axis=-1),
            0.0,
        )

        # Survivors migrate to their owner slab; absorbed particles are
        # parked mid-slab (dead state until next-step re-injection).
        p1 = jnp.where(is_act, x1 + lo, lo + 0.5)
        active_f = active.astype(jnp.float32)
        (p2, v2, q2, m2, s2, act2f), filled, mig2, drop2 = do_migrate(
            [p1, v1, q, m, species, active_f], filled, d
        )
        active2 = act2f.astype(jnp.int32)

        e_full = lax.all_gather(e1, ax, tiled=True)
        phi = integrate_neg_trapz(e_full, dx)
        phi = phi - jnp.max(phi)

        exit_hist = state.exit_hist + lax.psum(hist_d, ax)

        metrics = StepMetrics(
            field_energy=0.5 * EPSILON_0 * dx * lax.psum(jnp.sum(e1 * e1), ax),
            kinetic_energy=cfg.p2c * 0.5 * lax.psum(
                jnp.sum(jnp.where(filled, m2, 0.0) * u_of(v2)), ax
            ),
            current_bias=lax.psum(jnp.sum(j1), ax) / ng,
            picard_iters=k,
            picard_residual=r,
            n_active=lax.psum(
                jnp.sum((filled & (active2 == ACTIVE)).astype(jnp.int32)), ax
            ),
            n_lost_left=lax.psum(
                jnp.sum((filled & (active2 == LOST_LEFT)).astype(jnp.int32)),
                ax,
            ),
            n_lost_right=lax.psum(
                jnp.sum((filled & (active2 == LOST_RIGHT)).astype(jnp.int32)),
                ax,
            ),
            n_migrated=mig1 + mig2,
            n_dropped=drop1 + drop2,
            n_halo_clamped=n_halo_clamped,
            phi=phi,
        )
        new_state = state.replace(
            p=p2, v=v2, q=q2, m=m2, species=s2, active=active2,
            filled=filled, e=e1, j=j1, e_prev=e0, rng=key,
            exit_hist=exit_hist, step=state.step + 1,
        )
        return new_state, metrics

    def u_of(v2):
        return v2[:, 0] * v2[:, 0]

    spec = state_spec(cfg)
    # jit the shard_mapped step: an UN-jitted shard_map dispatches
    # eagerly op-by-op per shard (~1000x slower on the virtual CPU mesh);
    # callers that wrap it again in jax.jit / lax.scan are unaffected
    # (nested jit is free).
    return jax.jit(shard_map(
        local_step,
        mesh=mesh,
        in_specs=(spec,),
        out_specs=(spec, P()),
        check_vma=False,
    ))
