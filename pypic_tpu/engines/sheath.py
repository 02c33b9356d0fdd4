"""Bounded two-species 1d3v implicit sheath engine.

JAX rebuild of the gen-2 Dirichlet-Dirichlet ("DD" = absorbing walls on both
ends, *not* domain decomposition — SURVEY.md naming trap) plasma-sheath
driver ``main_i`` (PIC_L_DD.py:316-644):

* electrons + ions (mass ratio mp/me) with three velocity components, only
  v_x accelerated by the 1D field (PIC_L_DD.py:479-483);
* Langevin thermostat: with probability gamma an active particle's three
  velocity components are resampled from the ion-temperature Maxwellian
  (PIC_L_DD.py:420-427);
* re-injection at step start: particles absorbed in the previous step get a
  fresh uniform position and per-species Maxwellian velocities
  (PIC_L_DD.py:429-450);
* Picard loop (lax.while_loop, residual ||Es - Eh||_2, PIC_L_DD.py:525):
  bounded-gather the field guess at the position guess, Crank-Nicolson push
  of active particles, wall-absorption check on (x0, xh, x1) flipping the
  status flag to LOST_RIGHT (0) / LOST_LEFT (-1) (PIC_L_DD.py:493-505),
  current deposit including the wall surface-charge terms
  ``j[0] += dx q p2c / dt`` per left-absorbed particle (PIC_L_DD.py:55-63)
  and the edge fold ``j[0] += j[1]; j[-1] += j[-2]`` (PIC_L_DD.py:65-66),
  Ampere field advance without smoothing ``E1 = E0 + (dt/eps0)(<jh> - jh)``
  (PIC_L_DD.py:516), potential by cumulative trapezoid for diagnostics
  (PIC_L_DD.py:518-523);
* exit-velocity recording: the reference appends the outgoing x-velocity of
  absorbed first-half particles after step 2000 to a list (``vionout``,
  PIC_L_DD.py:495-504 — NB the reference's ``i < N/2`` guard selects the
  *electron* half despite the variable's name); the fixed-shape rebuild
  accumulates signed-outgoing-velocity histograms per species instead.

Dead/zeroed-state quirk preserved: the reference zeroes x1/u1/v1/w1 each
Picard iteration and only writes active particles (PIC_L_DD.py:459-467), so
absorbed particles carry zero state until re-injection; the rebuild masks
with ``where(active, value, 0)`` to match.

Diagnostic deviation (documented): kinetic energy uses the per-particle mass
(the reference's KE diagnostic hardcodes the electron mass for all species,
PIC_L_DD.py:549).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.pytree import PyTreeNode
from ..constants import EPSILON_0
from ..grid import GridSpec
from ..ops import (
    deposit,
    gather,
    grad_neg_bounded,
    histogram_add,
    integrate_neg_trapz,
)

ACTIVE = 1
LOST_RIGHT = 0  # absorbed at x >= L (PIC_L_DD.py:495-496)
LOST_LEFT = -1  # absorbed at x <= 0 (PIC_L_DD.py:500-501)


@dataclasses.dataclass(frozen=True)
class SheathConfig:
    grid: GridSpec  # bc='dirichlet-dirichlet', ng nodes, dx = L/(ng-1)
    dt: float
    p2c: float
    kbte: float  # electron kB T [J] for re-injection sampling
    kbti: float  # ion kB T [J] for re-injection + thermostat sampling
    tol: float = 1e-5  # PIC_L_DD.py:317
    # f32 residual-floor exit: the reference tolerance is ABSOLUTE
    # (||es - eh||_2 < 1e-5 in V/m) and unattainable in f32 once the field
    # reaches sheath magnitude (~2e4 V/m: one ulp of the iterate is
    # ~2.4e-3/component, so the residual plateaus around 5e-4 and the loop
    # burns iterations to maxiter making round-off-sized non-progress).
    # The loop also exits once r < tol_floor * eps * ||es||_2 (eps of the
    # WORKING dtype — f32 eps by default, f64 eps under x64 where the absolute
    # test is attainable and the floor correctly recedes to ~1e-11) — the
    # same fixed point to machine precision, measured plateau ~0.2x
    # eps*||es||. 0 restores the reference's pure-absolute test.
    # At the 1e6 bench config (warm state): 0 -> 13.6 mean iterations
    # grinding round-off, 0.25 -> 6.5, 0.5 -> 4.9 at mean exit residual
    # 5e-2 V/m on a ~2e4 V/m field (relative ~3e-6); iteration counts do
    # not depend on the device.
    tol_floor: float = 0.5
    maxiter: int = 20  # PIC_L_DD.py:318
    gamma: float = 0.0  # thermostat resampling probability (PIC_L_DD.py:331)
    deposit_method: str = "auto"
    # exit-velocity histogram (replaces the reference's dynamic vionout list)
    exit_hist_bins: int = 64
    exit_hist_vmax: float = 0.0  # [m/s]; 0 disables recording
    record_exit_after_step: int = 2000  # PIC_L_DD.py:497
    # Initial Picard iterate: 'field' = the reference's es0 = E0
    # (PIC_L_DD.py:456); 'extrapolate' = E0 + (E0 - E_prev)/2, the linear
    # half-step prediction — same fixed point and tolerance (see
    # engines.implicit.ImplicitConfig.picard_init).
    picard_init: str = "field"
    # 'anderson' = Anderson(1) secant mixing on the field iterate (same
    # fixed point, fewer iterations; decisive here — the bounded sheath's
    # plain Picard loop takes ~17 iterations at the reference tolerance,
    # see ops.accel and PERF.md).
    picard_accel: str = "none"
    # Re-injection / thermostat randomness. 'threefry' = jax.random streams
    # (the 'auto' choice on one device); 'hash' = counter-based murmur3 +
    # Box-Muller (sources.hash_uniforms — identical distribution, and
    # shard-count invariant, so 'auto' picks it under data-parallel
    # sharding). All samplers: same distributions, different draws.
    # Full-capacity draws are the reference semantics: every absorbed
    # particle re-injects at step start (PIC_L_DD.py:429-450).
    rng_sampler: str = "auto"
    # Data-parallel particle sharding over a 1D mesh axis (the magnetized
    # engine's pattern — wrap make_step with parallel.make_data_parallel_
    # step): per-shard current deposits INCLUDING the wall surface-charge
    # terms are psum-reduced before the edge fold and Ampere advance, so
    # the Picard loop iterates on the replicated global field with
    # identical trip counts on every shard; exit histograms and particle
    # counters psum. Randomness is shard-count-INVARIANT on the 'hash'
    # sampler (slot counters offset by the shard's global position —
    # thermostat, re-injection positions and velocities all reproduce the
    # single-device draws bit-for-bit; 'auto' resolves to hash under dp)
    # For the
    # sheath's reference-sized grids (ng ~ 51-200) dp is the natural
    # scaling axis: the slab-sharded variant (parallel.domain_sheath)
    # caps at ng shards.
    axis_name: Optional[str] = None

    def __post_init__(self):
        for f in ("dt", "p2c", "kbte", "kbti", "tol", "tol_floor", "gamma",
                  "exit_hist_vmax"):
            object.__setattr__(self, f, float(getattr(self, f)))
        for f in ("maxiter", "exit_hist_bins", "record_exit_after_step"):
            object.__setattr__(self, f, int(getattr(self, f)))
        if self.picard_init not in ("field", "extrapolate"):
            raise ValueError(f"unknown picard_init {self.picard_init!r}")
        if self.picard_accel not in ("none", "anderson", "anderson2"):
            from ..ops.accel import anderson_depth

            if anderson_depth(self.picard_accel) is None:
                raise ValueError(
                    f"unknown picard_accel {self.picard_accel!r}"
                )
        if self.rng_sampler not in ("auto", "hash", "threefry"):
            raise ValueError(f"unknown rng_sampler {self.rng_sampler!r}")
        if self.axis_name is not None:
            if self.rng_sampler == "threefry":
                raise ValueError(
                    "data-parallel full-capacity re-injection needs "
                    "rng_sampler='hash' (slot-offset counters give "
                    "shard-invariant draws; a replicated threefry key "
                    "would draw the SAME randoms on every shard) — 'auto' "
                    "resolves to hash here"
                )


class SheathState(PyTreeNode):
    p: jax.Array  # (n,) x in grid coordinates
    # velocities [m/s] as three flat (n,) leaves: (n, 3) arrays cost
    # slice/stack passes on every step; the ``v`` property provides the
    # stacked view for diagnostics
    u: jax.Array  # (n,) x velocity (the only field-accelerated component)
    vy: jax.Array  # (n,)
    vz: jax.Array  # (n,)
    q: jax.Array  # (n,) charge [C]
    m: jax.Array  # (n,) mass [kg]
    species: jax.Array  # (n,) int32: 1 = electron, 2 = ion (PIC_L_DD.py:241)
    active: jax.Array  # (n,) int32 in {1, 0, -1}
    e: jax.Array  # (ng,) field [V/m]
    j: jax.Array  # (ng,) current density [A/m^2]
    e_prev: jax.Array  # (ng,) previous-step field (picard_init='extrapolate')
    rng: jax.Array  # PRNG key
    exit_hist: jax.Array  # (2, bins) outgoing-velocity histograms (e-, ion)
    step: jax.Array  # () int32

    @property
    def v(self) -> jax.Array:
        """(n, 3) stacked velocity view (diagnostics/tests; not a leaf)."""
        return jnp.stack([self.u, self.vy, self.vz], axis=-1)


# old checkpoints stored the (n, 3) ``v`` leaf; split it on restore
# (checkpoint.load(migrate=...), wired up by cli --resume)
CHECKPOINT_MIGRATIONS = {
    ".v": lambda a: {".u": a[:, 0], ".vy": a[:, 1], ".vz": a[:, 2]},
}


class StepMetrics(NamedTuple):
    field_energy: jax.Array  # sum(eps0 E^2 dx / 2) (PIC_L_DD.py:548)
    kinetic_energy: jax.Array  # sum(m u^2 / 2) — per-particle mass (see module docstring)
    current_bias: jax.Array  # <j> (PIC_L_DD.py:551)
    picard_iters: jax.Array
    picard_residual: jax.Array
    n_active: jax.Array  # active particle count
    n_lost_left: jax.Array
    n_lost_right: jax.Array
    phi: jax.Array  # (ng,) potential from integrated E (PIC_L_DD.py:522-523)


def init_state(
    x, v3, q, m, species, cfg: SheathConfig, seed: int = 0, dtype=jnp.float32
) -> SheathState:
    """Wrap initializer output; initial j0 from the loaded particles
    (PIC_L_DD.py:385-389 — note the reference's initial Poisson solve is
    commented out there, so E0 starts at zero; preserved)."""
    grid = cfg.grid
    ng = grid.ng
    p = (jnp.asarray(x) / grid.dx).astype(dtype)
    v3 = jnp.asarray(v3, dtype)
    q = jnp.asarray(q, dtype)
    m = jnp.asarray(m, dtype)
    w = q * (cfg.p2c / grid.dx)
    j0 = deposit(p, w * v3[:, 0], ng, periodic=False, method=cfg.deposit_method)
    return SheathState(
        p=p,
        u=v3[:, 0],
        vy=v3[:, 1],
        vz=v3[:, 2],
        q=q,
        m=m,
        species=jnp.asarray(species, jnp.int32),
        active=jnp.full(p.shape, ACTIVE, jnp.int32),
        e=jnp.zeros((ng,), dtype),
        j=j0.astype(dtype),
        e_prev=jnp.zeros((ng,), dtype),
        rng=jax.random.PRNGKey(seed),
        exit_hist=jnp.zeros((2, cfg.exit_hist_bins), dtype),
        step=jnp.asarray(0, jnp.int32),
    )


def make_step(cfg: SheathConfig):
    grid = cfg.grid
    ng = grid.ng
    dx = grid.dx
    dt = cfg.dt
    dt_dx = dt / dx
    cells = float(grid.num_cells)  # L in grid coordinates
    ax = cfg.axis_name

    def _allreduce(x):
        """Sum per-shard partials across particle shards (no-op
        single-device)."""
        return lax.psum(x, ax) if ax else x

    def _deposit_currents(p, u, q, active):
        """CIC deposit of active particles' current + wall surface-charge
        terms + edge fold (PIC_L_DD.py:41-67). The psum sits between the
        (local-particle) deposit + wall terms and the (grid-level) edge
        fold."""
        is_active = active == ACTIVE
        w = jnp.where(is_active, q * (cfg.p2c / dx), 0.0)
        j = deposit(p, w * u, ng, periodic=False, method=cfg.deposit_method)
        wall = dx * cfg.p2c / dt
        j_left = wall * jnp.sum(jnp.where(active == LOST_LEFT, q, 0.0))
        j_right = -wall * jnp.sum(jnp.where(active == LOST_RIGHT, q, 0.0))
        j = j.at[0].add(j_left).at[-1].add(j_right)
        j = _allreduce(j)
        j = j.at[0].add(j[1]).at[-1].add(j[-2])
        return j

    def step(state: SheathState):
        key, k_therm_u, k_therm_v, k_reinj_x, k_reinj_v = jax.random.split(
            state.rng, 5
        )
        sampler = cfg.rng_sampler
        if sampler == "auto":
            # under dp the full-capacity draws must be shard-invariant ->
            # hash with slot offsets (config contract)
            sampler = "hash" if ax else "threefry"
        use_hash = sampler == "hash"
        if use_hash:
            from ..sources import hash_normals, hash_uniforms, seed_from_key
        if ax and not use_hash:
            # per-shard threefry streams (a replicated key would draw the
            # SAME randoms on every shard)
            k_therm_u = jax.random.fold_in(k_therm_u, lax.axis_index(ax))
            k_therm_v = jax.random.fold_in(k_therm_v, lax.axis_index(ax))

        p0, active = state.p, state.active
        u0, vy0, vz0 = state.u, state.vy, state.vz
        q, m, species = state.q, state.m, state.species
        e0 = state.e
        n_slots = p0.shape[0]
        # hash slot-counter offset: shard r draws the values the
        # single-device run draws for its slots (shard-count invariance)
        slot_off = lax.axis_index(ax) * n_slots if ax else 0
        kbt_per = jnp.where(species == 1, cfg.kbte, cfg.kbti)

        def _normals3(k):
            """Three (n,) standard-normal rows from the configured
            sampler (rows of a (3, n) draw stay contiguous — no
            (n, 3) relayout)."""
            if use_hash:
                z = hash_normals(seed_from_key(k), n_slots, 2,
                                 p0.dtype.type, offset=slot_off)
                return z[0], z[1], z[2]
            z = jax.random.normal(k, (3, n_slots), p0.dtype)
            return z[0], z[1], z[2]

        # --- Thermostat (PIC_L_DD.py:420-427): prob-gamma resample
        # to Ti.
        if cfg.gamma > 0.0:
            u_th = (
                hash_uniforms(seed_from_key(k_therm_u), n_slots, 1,
                              p0.dtype.type, offset=slot_off)[0]
                if use_hash else jax.random.uniform(k_therm_u, p0.shape)
            )
            hit = (active == ACTIVE) & (u_th < cfg.gamma)
            sig = jnp.sqrt(cfg.kbti / m)
            z0, z1, z2 = _normals3(k_therm_v)
            u0 = jnp.where(hit, z0 * sig, u0)
            vy0 = jnp.where(hit, z1 * sig, vy0)
            vz0 = jnp.where(hit, z2 * sig, vz0)

        # --- Re-injection (PIC_L_DD.py:429-450): absorbed particles
        # get a fresh uniform position and species-temperature
        # Maxwellian.
        lost = active != ACTIVE
        if use_hash:
            x_new = (
                hash_uniforms(seed_from_key(k_reinj_x), n_slots, 1,
                              p0.dtype.type, offset=slot_off)[0]
                * p0.dtype.type(cells)
            )
        else:
            x_new = jax.random.uniform(k_reinj_x, p0.shape,
                                       p0.dtype, 0.0, cells)
        z0, z1, z2 = _normals3(k_reinj_v)
        sig_re = jnp.sqrt(kbt_per / m)
        p0 = jnp.where(lost, x_new, p0)
        u0 = jnp.where(lost, z0 * sig_re, u0)
        vy0 = jnp.where(lost, z1 * sig_re, vy0)
        vz0 = jnp.where(lost, z2 * sig_re, vz0)
        active = jnp.where(lost, ACTIVE, active)

        qm = q / m

        def _hist_update(hist, act_prev, act_new):
            """Exit-velocity histograms from the status transition.

            Edge: a particle crossing BOTH walls within one Picard iteration
            (possible only for a re-injected particle drawn exactly at a
            wall) is binned by its final status (left); the pre-refactor
            inline code binned it as a right exit while still flagging it
            LOST_LEFT — a measure-zero diagnostic difference."""
            if cfg.exit_hist_vmax <= 0.0:
                return hist
            right = (act_prev == ACTIVE) & (act_new == LOST_RIGHT)
            left = (act_prev == ACTIVE) & (act_new == LOST_LEFT)
            vout = jnp.where(right, u0, jnp.where(left, -u0, 0.0))
            rec = (right | left) & (state.step >= cfg.record_exit_after_step)
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
            # replicated histogram state += psum'd per-shard exits under dp
            return hist + _allreduce(upd.reshape(2, bins))

        # --- Picard loop (PIC_L_DD.py:458-533).
        from ..ops.accel import (
            anderson2_mix,
            anderson_depth,
            anderson_m_mix,
            anderson_mix,
            mix_init,
        )

        accel = cfg.picard_accel
        accel_m = anderson_depth(accel)

        def _mix(es, eh, k, aux):
            if accel_m is not None:
                return anderson_m_mix(es, eh, k, aux, accel_m)
            if accel == "anderson":
                return anderson_mix(es, eh, k, aux)
            if accel == "anderson2":
                return anderson2_mix(es, eh, k, aux)
            return eh, aux

        es0 = (
            e0 + 0.5 * (e0 - state.e_prev)
            if cfg.picard_init == "extrapolate" else e0
        )

        # round-off floor of the WORKING dtype: under x64 the reference's
        # absolute tol is attainable and the floor must drop to f64 eps
        # rather than force an early f32-level exit
        eps_w = float(jnp.finfo(es0.dtype).eps)

        def cond(carry):
            r, k = carry[-2], carry[-1]
            keep = r > cfg.tol
            if cfg.tol_floor > 0.0:
                # carry[0] is the field iterate es in both loop layouts
                keep = keep & (
                    r > (cfg.tol_floor * eps_w) * jnp.linalg.norm(carry[0])
                )
            return keep & (k < cfg.maxiter)

        def body(carry):
            es, ps, _, _, act, hist, aux, _, k = carry
            act_prev = act
            is_active = act == ACTIVE
            e_p = jnp.where(
                is_active, gather(es, ps, periodic=False), 0.0
            )
            accel = qm * e_p
            x1 = p0 + dt_dx * u0 + (0.5 * dt * dt_dx) * accel
            u1 = u0 + dt * accel
            x1 = jnp.where(is_active, x1, 0.0)
            u1 = jnp.where(is_active, u1, 0.0)
            xh = jnp.where(is_active, 0.5 * (p0 + x1), 0.0)
            uh = jnp.where(is_active, 0.5 * (u0 + u1), 0.0)

            # Wall absorption on any of (x0, xh, x1) (PIC_L_DD.py:493-505).
            right = is_active & ((p0 >= cells) | (xh >= cells) | (x1 >= cells))
            left = is_active & ((p0 <= 0.0) | (xh <= 0.0) | (x1 <= 0.0))
            act = jnp.where(right, LOST_RIGHT, act)
            act = jnp.where(left, LOST_LEFT, act)

            hist = _hist_update(hist, act_prev, act)

            jh = _deposit_currents(xh, uh, q, act)
            j1 = _deposit_currents(x1, u1, q, act)
            e1 = e0 + (dt / EPSILON_0) * (jnp.mean(jh) - jh)
            eh = 0.5 * (e1 + e0)
            r = jnp.linalg.norm(es - eh)
            es_next, aux = _mix(es, eh, k, aux)
            return es_next, xh, (x1, u1), (e1, j1), act, hist, aux, r, k + 1

        carry0 = (
            es0, p0, (p0, u0), (e0, state.j), active, state.exit_hist,
            mix_init(e0, accel),
            jnp.asarray(jnp.inf, e0.dtype), jnp.asarray(0, jnp.int32),
        )
        (_, _, (x1, u1), (e1, j1), active, exit_hist, _, r,
         k) = lax.while_loop(cond, body, carry0)

        is_active = active == ACTIVE
        # reference dead-state quirk: absorbed particles carry zero state
        # until re-injection (PIC_L_DD.py:459-467); the KE metric below
        # intentionally uses the raw finalize u1 (pre-mask), as before
        u1s = jnp.where(is_active, u1, 0.0)
        vy1 = jnp.where(is_active, vy0, 0.0)
        vz1 = jnp.where(is_active, vz0, 0.0)

        phi = integrate_neg_trapz(e1, dx)
        phi = phi - jnp.max(phi)

        metrics = StepMetrics(
            field_energy=0.5 * EPSILON_0 * dx * jnp.sum(e1 * e1),
            kinetic_energy=_allreduce(cfg.p2c * 0.5 * jnp.sum(m * u1 * u1)),
            current_bias=jnp.mean(j1),
            picard_iters=k,
            picard_residual=r,
            n_active=_allreduce(jnp.sum(is_active.astype(jnp.int32))),
            n_lost_left=_allreduce(
                jnp.sum((active == LOST_LEFT).astype(jnp.int32))),
            n_lost_right=_allreduce(
                jnp.sum((active == LOST_RIGHT).astype(jnp.int32))),
            phi=phi,
        )
        new_state = state.replace(
            p=x1, u=u1s, vy=vy1, vz=vz1, active=active, e=e1, j=j1,
            e_prev=e0, rng=key, exit_hist=exit_hist, step=state.step + 1,
        )
        return new_state, metrics

    return step
