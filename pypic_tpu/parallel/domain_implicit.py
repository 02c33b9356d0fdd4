"""Domain-decomposed implicit CN-Picard engine (slab-sharded fields).

Composes the flagship energy-conserving engine (pypic.py:216-300, rebuilt in
``pypic_tpu.engines.implicit``) with the slab machinery of
``pypic_tpu.parallel.domain`` — and goes one step further than the explicit
carrier: **the grid never exists globally**. The Ampere-law field advance
``E1 = E0 + (dt/eps0)(<jh> - smooth(jh))`` (pypic.py:283) is local up to a
scalar psum (the mean) and a radius-1 binomial stencil (a 1-node halo), so E
and j stay slab-sharded through the whole Picard loop:

* per iteration, each shard gathers the smoothed field guess from a
  halo-extended slab (width ``halo + 2`` nodes, covering the worst-case
  intra-step particle excursion), runs the Crank-Nicolson update in local
  slab coordinates, and deposits the half-/full-step currents onto the
  extended slab, folding halo contributions back to their owners with
  ``ppermute`` — per-device grid work is O(ng/D + halo), never O(ng);
* the Picard residual ``||Es - Eh||^2`` (pypic.py:289) and the current mean
  are psum-reduced scalars, so the ``lax.while_loop`` trip count is
  replicated across shards by construction;
* particles whose half-step excursion exceeds ``halo`` cells are clamped to
  the halo edge for grid operations and **counted** (``n_halo_clamped``) —
  detected, never silent; size ``halo`` against dt * v_max / dx;
* after convergence the final positions wrap and multi-hop migrate to their
  owner slabs (``domain.migrate``).

This is the BASELINE.json configs[4] workload ("domain-decomposed run at
1e8 particles ... with halo exchange").
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
from ..grid import GridSpec
from ..ops import deposit, gather, grad_periodic, solve_periodic_neutralized
from ..ops.picard import picard_finalize, picard_pass
from .domain import (
    distribute_by_slab,
    halo_extend,
    halo_fold,
    migrate,
    ring_perms,
    state_spec,  # noqa: F401  (1D helper, kept importable)
)

shard_map = jax.shard_map


@dataclasses.dataclass(frozen=True)
class DomainImplicitConfig:
    grid: GridSpec  # periodic; ng must divide by num_shards
    dt: float
    p2c: float
    num_shards: int
    tol: float = 1e-3  # on ||Es - Eh||^2 (pypic.py:859)
    maxiter: int = 20  # pypic.py:860
    halo: int = 4  # max intra-step particle excursion, cells
    migrate_cap: int = 4096
    smooth: bool = True  # pypic.py:261,283 (False = gen-1 PIC_L.py variant)
    # 'field' = reference start es0 = E0 (pypic.py:253); 'extrapolate' =
    # linear prediction E0 + (E0 - E_prev)/2 — same fixed point/tolerance,
    # ~1 fewer Picard iteration; 'extrapolate2' = quadratic prediction
    # (15 E0 - 10 E_prev + 3 E_prev2)/8 (see engines.implicit.ImplicitConfig).
    picard_init: str = "field"
    # 'converged' (default) recomputes (p1, v1) from the *converged*
    # half-step field with one extra fused sweep, skipping the purely-
    # diagnostic j1 deposit (state.j = half-step current); 'converged-
    # deposit' also deposits the true j1; 'iterate' returns the last Picard
    # iterate like the reference (pypic.py:293-295) with no extra sweep but
    # its last-iterate drift bias (see engines.implicit.ImplicitConfig
    # .finalize and PERF.md's drift table). Fused backend only.
    finalize: str = "converged"
    # Field the finalize sweep gathers with (fused backend, finalize !=
    # 'iterate'): 'last' | 'mean2' | 'map' | 'aitken' — see
    # engines.implicit.ImplicitConfig.finalize_field. The aitken Δ²
    # contraction estimate psums its two inner products over the slab
    # axis, so the slab-sharded extrapolation equals the global one.
    # Accuracy/diagnostics option: fixed-3 + 'aitken' fails the 1e4-step
    # drift criterion at 1e8 (PERF.md), so the headline stays maxiter=4 +
    # 'last'.
    finalize_field: str = "last"
    # 'fused' runs each local Picard pass as one particle sweep over the
    # shard's particles (ops.picard on the halo-extended slab — the domain
    # form of engines.implicit's fused backend) and honours every finalize
    # mode; 'composed' assembles the reference's loop body from individual
    # ops and returns its last iterate; 'auto' = fused.
    backend: str = "auto"
    # Picard iterate mixing (see engines.implicit.ImplicitConfig.picard_accel
    # and ops.accel): same fixed point and residual test; the secant inner
    # products are psum'd over the slab axis so mixing on the slab-sharded
    # field equals mixing on the global one. 'anderson' + maxiter=4 +
    # tol=1e-30 + picard_init='extrapolate' is the conserving configuration
    # (PERF.md round-3 drift table).
    picard_accel: str = "none"
    axis_name: str = "slabs"
    deposit_method: str = "auto"
    # Data-parallel axis composed WITH the slab axis on a 2D device mesh
    # (slabs x replicas): each slab's particles split over num_replicas
    # devices, fields slab-sharded and replicated across replicas, slab
    # deposits psum'd over the replica axis, migration rides the slab axis
    # within each replica independently (no replica-axis traffic). This is
    # how the engine scales past one device per slab — mesh via
    # make_mesh2(num_shards, num_replicas).
    dp_axis_name: str | None = None
    num_replicas: int = 1

    def __post_init__(self):
        for f in ("dt", "p2c", "tol"):
            object.__setattr__(self, f, float(getattr(self, f)))
        for f in ("maxiter", "halo", "migrate_cap", "num_shards",
                  "num_replicas"):
            object.__setattr__(self, f, int(getattr(self, f)))
        if self.grid.ng % self.num_shards:
            raise ValueError(
                f"ng={self.grid.ng} not divisible by {self.num_shards} shards"
            )
        if (self.num_replicas > 1) != (self.dp_axis_name is not None):
            raise ValueError(
                "num_replicas > 1 requires dp_axis_name (and vice versa)"
            )
        if self.halo + 3 > self.cells_per_shard:
            raise ValueError(
                f"halo={self.halo} too large for {self.cells_per_shard}-cell "
                "slabs (need halo + 3 <= cells_per_shard)"
            )
        if self.picard_init not in ("field", "extrapolate", "extrapolate2"):
            raise ValueError(f"unknown picard_init {self.picard_init!r}")
        if self.finalize not in ("converged", "converged-deposit", "iterate"):
            raise ValueError(f"unknown finalize {self.finalize!r}")
        if self.finalize_field not in ("last", "mean2", "map", "aitken"):
            raise ValueError(f"unknown finalize_field {self.finalize_field!r}")
        if self.finalize == "iterate" and self.finalize_field != "last":
            raise ValueError(
                "finalize='iterate' has no finalize sweep to redirect — "
                f"finalize_field={self.finalize_field!r} would be silently "
                "ignored; use finalize='converged' (or finalize_field='last')"
            )
        if self.picard_accel not in ("none", "anderson", "anderson2",
                                     "damped"):
            raise ValueError(f"unknown picard_accel {self.picard_accel!r}")

    @property
    def cells_per_shard(self) -> int:
        return self.grid.ng // self.num_shards


class DomainImplicitState(PyTreeNode):
    p: jax.Array  # (S*capacity,) global grid coords, sharded
    v: jax.Array  # (S*capacity,) [m/s], sharded
    alive: jax.Array  # (S*capacity,) bool, sharded
    q: jax.Array  # () [C]
    m: jax.Array  # () [kg]
    e: jax.Array  # (ng,) [V/m], slab-sharded
    j: jax.Array  # (ng,) [A/m^2], slab-sharded
    e_prev: jax.Array  # (ng,) previous-step field (picard_init='extrapolate')
    e_prev2: jax.Array  # (ng,) field two steps back (picard_init='extrapolate2')
    step: jax.Array  # () int32


class StepMetrics(NamedTuple):
    field_energy: jax.Array
    kinetic_energy: jax.Array
    current_bias: jax.Array
    picard_iters: jax.Array
    picard_residual: jax.Array
    n_alive: jax.Array
    n_migrated: jax.Array
    n_dropped: jax.Array
    n_halo_clamped: jax.Array  # final-iterate excursions beyond the halo


def init_state(
    x, v, q, m, cfg: DomainImplicitConfig, capacity_factor: float = 1.5,
) -> DomainImplicitState:
    """Slab-distribute particles; initial Poisson solve for E0 and deposit of
    j0 on the full grid (pypic.py:549-554), then slab-split — init is host
    side and O(ng) once."""
    grid = cfg.grid
    ng = grid.ng
    dx = grid.dx
    p_glob = (jnp.asarray(x) / dx).astype(jnp.float32)
    v_glob = jnp.asarray(v, jnp.float32)
    w = float(q) * (cfg.p2c / dx)
    rho0 = deposit(p_glob, jnp.full_like(p_glob, w), ng, periodic=True,
                   method="scatter")
    j0 = deposit(p_glob, w * v_glob, ng, periodic=True, method="scatter")
    phi0 = solve_periodic_neutralized(rho0, dx)
    phi0 = phi0 - jnp.max(phi0)
    e0 = -grad_periodic(phi0, dx)

    (p_out, v_out), alive, _ = distribute_by_slab(
        [np.asarray(p_glob), np.asarray(v_glob)], x, cfg, capacity_factor
    )
    if cfg.num_replicas > 1:
        # Split each slab's population round-robin over the replica axis:
        # layout (S, R, cap_r) so sharding P((slabs, dp)) puts replica r of
        # slab s on device (s, r).
        r_tot = cfg.num_replicas
        cap_r = -(-p_out.shape[1] // r_tot)

        def split(a, fill):
            out = np.full((a.shape[0], r_tot, cap_r), fill, a.dtype)
            for r in range(r_tot):
                cols = a[:, r::r_tot]
                out[:, r, : cols.shape[1]] = cols
            return out

        p_out = split(p_out, 0.0)
        v_out = split(v_out, 0.0)
        alive = split(alive, False)
    return DomainImplicitState(
        p=jnp.asarray(p_out.reshape(-1)),
        v=jnp.asarray(v_out.reshape(-1)),
        alive=jnp.asarray(alive.reshape(-1)),
        q=jnp.asarray(q, jnp.float32),
        m=jnp.asarray(m, jnp.float32),
        e=e0.astype(jnp.float32),
        j=j0.astype(jnp.float32),
        e_prev=e0.astype(jnp.float32),
        e_prev2=e0.astype(jnp.float32),
        step=jnp.asarray(0, jnp.int32),
    )


def _state_specs(cfg) -> DomainImplicitState:
    """PartitionSpecs: particles over (slabs[, dp]), fields over slabs
    (replicated across dp), scalars replicated."""
    ax = cfg.axis_name
    pp = P((ax, cfg.dp_axis_name)) if cfg.dp_axis_name else P(ax)
    return DomainImplicitState(
        p=pp, v=pp, alive=pp, q=P(), m=P(), e=P(ax), j=P(ax),
        e_prev=P(ax), e_prev2=P(ax), step=P(),
    )


def shard_state(state, mesh: Mesh, cfg) -> DomainImplicitState:
    return jax.tree.map(
        lambda leaf, s: jax.device_put(
            leaf, jax.sharding.NamedSharding(mesh, s)
        ),
        state, _state_specs(cfg),
    )


def make_step(cfg: DomainImplicitConfig, mesh: Mesh):
    """Per-step-migration stepper: step(state) -> (state, scalar metrics)."""
    return _make_stepper(cfg, mesh, None)


def make_superstep(cfg: DomainImplicitConfig, mesh: Mesh, migrate_every: int):
    """Migration-amortized superstep: run ``migrate_every`` CN-Picard
    micro-steps back-to-back and wrap + migrate particles ONCE, on the last.

    The extended-slab gathers/deposits already handle any excursion within
    ``cfg.halo`` cells of the owning slab (halo contributions ride
    ``ppermute`` back to their owners), so per-step migration is
    bookkeeping, not physics — it only keeps excursions bounded, and its
    routing costs the same whether or not any particle moves.

    Size ``halo >= migrate_every * v_max * dt / dx``: particles that
    outrun the halo mid-superstep are clamped for grid work and counted in
    ``n_halo_clamped`` (per micro-step) — detected, never silent.

    Contract: superstep(state) -> (state, metrics) where every StepMetrics
    leaf gains a leading (migrate_every,) axis — one entry per micro-step.
    ``n_migrated``/``n_dropped`` are nonzero only in the last slot and
    ``n_alive`` reflects post-migration survivors there; ``state.step``
    advances by ``migrate_every``. Trajectories equal the per-step-migrate
    stepper's up to f32 reduction-order (deposit fold grouping differs for
    off-slab particles).
    """
    migrate_every = int(migrate_every)
    if migrate_every < 1:
        raise ValueError(f"migrate_every must be >= 1, got {migrate_every}")
    return _make_stepper(cfg, mesh, migrate_every)


def _make_stepper(cfg: DomainImplicitConfig, mesh: Mesh, k_mig):
    """Shared builder: ``k_mig=None`` -> the per-step path (scalar
    metrics); ``k_mig=k`` -> the k-micro-step superstep (stacked
    metrics)."""
    grid = cfg.grid
    ng = grid.ng
    dx = grid.dx
    dt = cfg.dt
    dt_dx = dt / dx
    c = cfg.cells_per_shard
    d_tot = cfg.num_shards
    ax = cfg.axis_name
    dp = cfg.dp_axis_name
    axes_all = (ax, dp) if dp else ax

    def dpsum(x):
        """Merge per-replica partial slab deposits / counts (no-op 1D)."""
        return lax.psum(x, dp) if dp else x

    h = cfg.halo
    hw = h + 2  # +1 smoothing stencil, +1 CIC right node
    ext_n = c + 2 * hw + 1
    perm_r, perm_l = ring_perms(d_tot)

    def smooth_own(f_own):
        """Periodic binomial smoother on a slab-sharded field: radius-1
        stencil via a 1-node halo (equals ops.smooth_periodic globally)."""
        left = lax.ppermute(f_own[-1:], ax, perm_r)
        right = lax.ppermute(f_own[:1], ax, perm_l)
        ext = jnp.concatenate([left, f_own, right])
        return 0.25 * (ext[:-2] + 2.0 * ext[1:-1] + ext[2:])

    def smooth_valid(ext):
        """Binomial smooth of an extended slab; valid on the interior, so the
        result covers [lo - hw + 1, lo + c + hw - 1]."""
        return 0.25 * (ext[:-2] + 2.0 * ext[1:-1] + ext[2:])

    def clamp_loc(pl):
        return jnp.clip(pl, -float(h), float(c + h))

    if cfg.backend not in ("auto", "fused", "composed"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    use_fused = cfg.backend != "composed"  # q/m are always scalars here
    if not use_fused and cfg.finalize_field != "last":
        raise ValueError(
            "finalize_field != 'last' requires the fused backend (the "
            "composed path returns the last Picard iterate's arrays and "
            "has no finalize sweep to redirect)")
    # clamp bounds in shifted (halo/deposit) coordinates: xi in [-h, c+h]
    clamp_lo_s = float(hw - h)
    clamp_hi_s = float(c + h + hw)

    def slab_deposit(pl, val):
        ext = deposit(
            clamp_loc(pl) + hw, val, ext_n,
            periodic=False, method=cfg.deposit_method,
        )
        return dpsum(halo_fold(ext, c, hw, ax, perm_r, perm_l))

    def smoothed_ext(es):
        """Halo-extend (+ smooth) the field guess in the shifted deposit
        coordinate system (ext_n nodes). With smoothing, the end nodes
        are zero padding outside the clamp range — never gathered."""
        e_ext = halo_extend(es, hw, ax, perm_r, perm_l)
        if not cfg.smooth:
            return e_ext
        z = jnp.zeros((1,), e_ext.dtype)
        return jnp.concatenate([z, smooth_valid(e_ext), z])

    def ampere(es, jh, e0):
        # Ampere advance (pypic.py:283): the mean is a psum, the smoother
        # a 1-node halo — no global grid anywhere.
        j_mean = lax.psum(jnp.sum(jh), ax) / ng
        e1 = e0 + (dt / EPSILON_0) * (
            j_mean - (smooth_own(jh) if cfg.smooth else jh)
        )
        eh = 0.5 * (e1 + e0)
        r = lax.psum(jnp.sum((es - eh) ** 2), ax)
        return e1, eh, r

    def cond(carry):
        # shared by both backends (their carries differ in length):
        # residual and iteration count ride at the end
        return (carry[-2] > cfg.tol) & (carry[-1] < cfg.maxiter)

    def mix(es, eh, k, aux):
        """Next Picard iterate from the map output eh (ops.accel): the
        secant inner products psum over the slab axis, so mixing the
        slab-sharded field equals mixing the global one. Fields are
        replicated across the dp axis — no dp psum needed."""
        from ..ops.accel import anderson2_mix, anderson_mix, damped_mix

        if cfg.picard_accel == "anderson":
            return anderson_mix(es, eh, k, aux, psum_axis=ax)
        if cfg.picard_accel == "anderson2":
            return anderson2_mix(es, eh, k, aux, psum_axis=ax)
        if cfg.picard_accel == "damped":
            return damped_mix(es, eh, k, aux)
        return eh, aux

    def init_guess(e0, e_prev, e_prev2):
        if cfg.picard_init == "extrapolate":
            return e0 + 0.5 * (e0 - e_prev)
        if cfg.picard_init == "extrapolate2":
            return 0.125 * (15.0 * e0 - 10.0 * e_prev + 3.0 * e_prev2)
        return e0

    emit_v = cfg.finalize == "iterate"
    # finalize_field history: the last Picard map outputs ride the carry
    # (slab-sharded like every field leaf); 'iterate' has no finalize
    # sweep to redirect, so the history is skipped (engines.implicit
    # semantics).
    keep_eh = cfg.finalize_field in ("mean2", "map", "aitken") and not emit_v
    keep_eh2 = cfg.finalize_field == "aitken" and not emit_v
    # the shared Picard pass (ops.picard) on the bounded extended slab
    sweep = dict(dt=dt, dx=dx, lo=clamp_lo_s, hi=clamp_hi_s,
                 method=cfg.deposit_method)

    def make_body_composed(p0l, v0, w, e0, qm):
        """Picard map as individual ops, closing over this micro-step's
        start-of-step arrays (local coordinates)."""

        def body_composed(carry):
            es, psl, _, _, _, aux, _, k = carry
            # Gather the smoothed field guess at the position guess
            # (pypic.py:261) from the halo-extended slab.
            e_ext = halo_extend(es, hw, ax, perm_r, perm_l)
            if cfg.smooth:
                g_ext, off = smooth_valid(e_ext), hw - 1
            else:
                g_ext, off = e_ext, hw
            e_p = gather(g_ext, clamp_loc(psl) + off, periodic=False)
            # Crank-Nicolson update in slab coordinates (pypic.py:264-265).
            accel = qm * e_p
            p1l = p0l + dt_dx * v0 + (0.5 * dt * dt_dx) * accel
            v1 = v0 + dt * accel
            phl = 0.5 * (p0l + p1l)
            vh = 0.5 * (v0 + v1)
            jh = slab_deposit(phl, w * vh)
            j1 = slab_deposit(p1l, w * v1)
            e1, eh, r = ampere(es, jh, e0)
            es_next, aux = mix(es, eh, k, aux)
            return es_next, phl, (p1l, v1), e1, j1, aux, r, k + 1

        return body_composed

    def make_body_fused(p0s, v0, w, e0, qm):
        """Fused Picard map (ops.picard.picard_pass), closing over this
        micro-step's start-of-step arrays (shifted deposit coordinates)."""

        def body_fused(carry):
            es, pss = carry[0], carry[1]  # pss: shifted position iterate
            outs = picard_pass(smoothed_ext(es), pss, p0s, v0, ext_n,
                               qm=qm, w=w, emit_v=emit_v, **sweep)
            jh = dpsum(halo_fold(outs[-1], c, hw, ax, perm_r, perm_l))
            e1, eh, r = ampere(es, jh, e0)
            es_next, aux = mix(es, eh, carry[-1], carry[-3])
            if emit_v:
                return (es_next, outs[0], outs[1], e1, jh, aux, r,
                        carry[-1] + 1)
            if keep_eh:
                # shift the map-output history: carry[2] = eh_k, [3] = eh_{k-1}
                # (+ [4] = eh_{k-2} for aitken)
                hist = (eh, carry[2]) + ((carry[3],) if keep_eh2 else ())
                return (es_next, outs[0]) + hist + (
                    e1, jh, aux, r, carry[-1] + 1)
            return es_next, outs[0], e1, jh, aux, r, carry[-1] + 1

        return body_fused

    def _hist0(es0):
        """Carry seeds for the finalize_field map-output history."""
        if not keep_eh:
            return ()
        return (es0, es0) + ((es0,) if keep_eh2 else ())

    def _finalize_field(out):
        """Field the finalize sweep gathers with (engines.implicit.step_fused
        semantics; the aitken ρ inner products psum over the slab axis so
        the slab-sharded Δ² extrapolation equals the global one — fields
        are replicated across the dp axis, no dp psum needed)."""
        ef = out[0]
        k = out[-1]
        if not keep_eh:
            return ef
        ehl, ehp = out[2], out[3]
        if cfg.finalize_field == "map":
            return ehl
        if cfg.finalize_field == "mean2":
            # at k == 1 ehp still holds the seed es0 (a prediction, not a
            # map output) — fall back to the single output
            return jnp.where(k > 1, 0.5 * (ehl + ehp), ehl)
        ehpp = out[4]  # 'aitken'
        d1 = ehl - ehp
        d2 = ehp - ehpp
        den = lax.psum(jnp.sum(d2 * d2), ax)
        rho = lax.psum(jnp.sum(d1 * d2), ax)
        rho = rho / jnp.where(den > 0.0, den, 1.0)
        rho = jnp.clip(rho, -0.95, 0.95)
        trust = (k > 2) & (den > 0.0)
        corr = (rho / (1.0 - rho)) * d1
        return ehl + jnp.where(trust, corr, jnp.zeros_like(corr))

    def picard_step(p0l, v0, w, qm, e0, j_in, e_prev, e_prev2):
        """One CN-Picard step in this shard's local slab coordinates.

        Returns (p1l, v1, e1, j1, mean_j1, k, r): raw local final positions
        (the caller wraps and migrates), the advanced field and the current
        stored in state.j (see DomainImplicitConfig.finalize)."""
        from ..ops.accel import mix_init

        es0 = init_guess(e0, e_prev, e_prev2)
        aux0 = mix_init(e0, cfg.picard_accel)
        inf_r = jnp.asarray(jnp.inf, e0.dtype)
        zero_i = jnp.asarray(0, jnp.int32)
        if not use_fused:
            carry0 = (es0, p0l, (p0l, v0), e0, j_in, aux0, inf_r, zero_i)
            _, _, (p1l, v1), e1, j1, _, r, k = lax.while_loop(
                cond, make_body_composed(p0l, v0, w, e0, qm), carry0)
            return p1l, v1, e1, j1, lax.psum(jnp.sum(j1), ax) / ng, k, r

        p0s = p0l + hw
        body = make_body_fused(p0s, v0, w, e0, qm)
        if emit_v:
            carry0 = (es0, p0s, v0, e0, j_in, aux0, inf_r, zero_i)
            _, _, v1, e1, jh, _, r, k = lax.while_loop(cond, body, carry0)
            # Last Picard iterate, no extra sweep (pypic.py:293-295):
            # p1 = p0 + dt/dx (v0 + v1)/2 elementwise; state.j holds the
            # half-step current that drove the Ampere advance; the exact
            # mean of the skipped full-step deposit is w sum(v1)/ng.
            p1l = p0l + (0.5 * dt_dx) * (v0 + v1)
            mean_j1 = lax.psum(jnp.sum(w * v1), axes_all) / ng
            return p1l, v1, e1, jh, mean_j1, k, r
        carry0 = (es0, p0s) + _hist0(es0) + (e0, j_in, aux0, inf_r, zero_i)
        out = lax.while_loop(cond, body, carry0)
        pss, e1, jh, r, k = out[1], out[-5], out[-4], out[-2], out[-1]
        # finalize from the converged field (engines.implicit fused
        # semantics): one extra sweep yields (p1, v1)
        f_ext = smoothed_ext(_finalize_field(out))
        if cfg.finalize == "converged":
            p1s, v1 = picard_finalize(f_ext, pss, p0s, v0, ext_n, qm=qm,
                                      **sweep)
            mean_j1 = lax.psum(jnp.sum(w * v1), axes_all) / ng
            j1 = jh
        else:  # 'converged-deposit'
            p1s, v1, j1_ext = picard_finalize(f_ext, pss, p0s, v0, ext_n,
                                              qm=qm, w=w, **sweep)
            j1 = dpsum(halo_fold(j1_ext, c, hw, ax, perm_r, perm_l))
            mean_j1 = lax.psum(jnp.sum(j1), ax) / ng
        return p1s - hw, v1, e1, j1, mean_j1, k, r

    def step_metrics(e1, v1, p1l, alive, m, mean_j1, k, r, n_alive,
                     n_migrated, n_dropped):
        return StepMetrics(
            field_energy=0.5 * EPSILON_0 * dx * lax.psum(jnp.sum(e1 * e1), ax),
            kinetic_energy=0.5 * cfg.p2c * m * lax.psum(
                jnp.sum(jnp.where(alive, v1 * v1, 0.0)), axes_all),
            current_bias=mean_j1,
            picard_iters=k,
            picard_residual=r,
            n_alive=n_alive,
            n_migrated=n_migrated,
            n_dropped=n_dropped,
            # final-iterate excursions beyond the halo (clamped for grid
            # work above — detected, never silent)
            n_halo_clamped=lax.psum(
                jnp.sum((alive & ((p1l < -h) | (p1l > c + h))
                         ).astype(jnp.int32)),
                axes_all,
            ),
        )

    def local_step(state: DomainImplicitState):
        d = lax.axis_index(ax)
        lo = d.astype(state.p.dtype) * c
        alive = state.alive
        # Dead slots are inert without masking copies: their deposit weight
        # w is zero, gathers clamp to the halo range, and every downstream
        # consumer (migration routing, metrics, clamp counters) masks by
        # `alive` — so p/v carry stale-but-finite values in dead slots.
        w = jnp.where(alive, state.q * (cfg.p2c / dx), 0.0)
        p1l, v1, e1, j1, mean_j1, k, r = picard_step(
            state.p - lo, state.v, w, state.q / state.m, state.e, state.j,
            state.e_prev, state.e_prev2)
        # Wrap to global coordinates (dead slots wrap too — finite
        # garbage, masked by `alive` inside migration).
        p1 = jnp.mod(p1l + lo, ng)
        (p2, v2), alive1, n_migrated, n_dropped = migrate(
            [p1, v1], alive, d,
            ng=ng, cells_per_shard=c, num_shards=d_tot,
            cap=cfg.migrate_cap, ax=ax,
            # replicas must agree on the round count or the whole-mesh
            # ppermute rendezvous deadlocks (see domain.migrate count_axes)
            count_axes=axes_all,
        )
        metrics = step_metrics(
            e1, v1, p1l, alive, state.m, mean_j1, k, r,
            lax.psum(jnp.sum(alive1.astype(jnp.int32)), axes_all),
            dpsum(n_migrated), dpsum(n_dropped))
        new_state = state.replace(
            p=p2, v=v2, alive=alive1, e=e1, j=j1, e_prev=state.e,
            e_prev2=state.e_prev, step=state.step + 1
        )
        return new_state, metrics

    def local_superstep(state: DomainImplicitState):
        """k_mig micro-steps with ONE wrap + migrate at the end.

        Micro-steps carry positions raw in this superstep's slab frame
        (local coordinates): the extended-slab grid ops are correct for
        any excursion within the halo, and excursions beyond it are
        clamped-for-grid-work + counted exactly as in the per-step path.
        Only the last micro-step converts to global coordinates and routes
        particles to their owners."""
        d = lax.axis_index(ax)
        lo = d.astype(state.p.dtype) * c
        alive = state.alive
        qm = state.q / state.m
        w = jnp.where(alive, state.q * (cfg.p2c / dx), 0.0)
        n_alive0 = lax.psum(jnp.sum(alive.astype(jnp.int32)), axes_all)
        zero_i = jnp.asarray(0, jnp.int32)

        def micro(p_l, v_c, e0, j_in, e_prev, e_prev2):
            p1l, v1, e1, j1, mean_j1, k, r = picard_step(
                p_l, v_c, w, qm, e0, j_in, e_prev, e_prev2)
            met = step_metrics(e1, v1, p1l, alive, state.m, mean_j1, k, r,
                               n_alive0, zero_i, zero_i)
            return p1l, v1, e1, j1, met

        carry0 = (state.p - lo, state.v, state.e, state.j,
                  state.e_prev, state.e_prev2)
        if k_mig > 1:
            def scan_body(cr, _):
                p_l, v_c, e, j, ep, ep2 = cr
                p1l, v1, e1, j1, met = micro(p_l, v_c, e, j, ep, ep2)
                return (p1l, v1, e1, j1, e, ep), met

            carry, ms = lax.scan(scan_body, carry0, None, length=k_mig - 1)
        else:
            carry, ms = carry0, None
        p_l, v_c, e_c, j_c, ep_c, ep2_c = carry
        p1l, v1, e1, j1, met_last = micro(p_l, v_c, e_c, j_c, ep_c, ep2_c)
        p1 = jnp.mod(p1l + lo, ng)

        (p2, v2), alive1, n_migrated, n_dropped = migrate(
            [p1, v1], alive, d,
            ng=ng, cells_per_shard=c, num_shards=d_tot,
            cap=cfg.migrate_cap, ax=ax,
            count_axes=axes_all,
        )
        met_last = met_last._replace(
            n_migrated=dpsum(n_migrated),
            n_dropped=dpsum(n_dropped),
            n_alive=lax.psum(jnp.sum(alive1.astype(jnp.int32)), axes_all),
        )
        if ms is None:
            metrics = jax.tree.map(lambda x: jnp.asarray(x)[None], met_last)
        else:
            metrics = jax.tree.map(
                lambda s, x: jnp.concatenate([s, jnp.asarray(x)[None]]),
                ms, met_last,
            )
        new_state = state.replace(
            p=p2, v=v2, alive=alive1, e=e1, j=j1, e_prev=e_c,
            e_prev2=ep_c, step=state.step + k_mig,
        )
        return new_state, metrics

    spec = _state_specs(cfg)
    # jit the shard_mapped step: an UN-jitted shard_map dispatches
    # eagerly op-by-op per shard (~1000x slower on the virtual CPU mesh);
    # callers that wrap it again in jax.jit / lax.scan are unaffected
    # (nested jit is free).
    return jax.jit(shard_map(
        local_step if k_mig is None else local_superstep,
        mesh=mesh,
        in_specs=(spec,),
        out_specs=(spec, P()),
        check_vma=False,
    ))
