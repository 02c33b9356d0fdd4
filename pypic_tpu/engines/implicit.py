"""Implicit energy-conserving periodic PIC engine (Crank-Nicolson + Picard).

The flagship engine — a JAX rebuild of the gen-3 numba hot kernel
``particle_push_p`` (pypic.py:216-300) and its driver ``implicit_pic``
(pypic.py:472-651):

* the Picard fixed-point iteration becomes a ``lax.while_loop`` with the
  reference's (tol, maxiter) envelope on ||Es - Eh||^2 (pypic.py:259, 289);
* each iteration: gather the binomially-smoothed field guess at the position
  guess (pypic.py:261), Crank-Nicolson position/velocity update
  (pypic.py:264-265), half-step and full-step current deposits
  (pypic.py:267-279), Ampere's-law field advance
  ``E1 = E0 + (dt/eps0) (<jh> - smooth(jh))`` (pypic.py:283), residual on the
  half-step field (pypic.py:285-289);
* the sequential scatter deposits become matmul/segment deposits
  (pypic_tpu.ops.cic);
* Picard iteration count and residual are returned as step metrics (the
  reference prints them, pypic.py:297-298).

The scheme conserves total energy to the Picard tolerance — the property the
drift acceptance test checks (<0.1% per 1e4 steps, BASELINE.md).

State carries per-particle q/m/mass as either scalars (single-species fast
path: initialize_p loads all electrons, pypic.py:425-426) or (n,) arrays
(the gen-1 implicit two-stream mixes electrons and ions, PIC_L.py:339) —
broadcasting covers both with zero code divergence.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .. import platform
from ..constants import EPSILON_0
from ..grid import GridSpec
from ..ops import (
    deposit,
    gather,
    grad_periodic,
    smooth_periodic,
    solve_periodic_neutralized,
)
from ..ops.picard import picard_finalize, picard_pass
from ..utils.pytree import PyTreeNode


@dataclasses.dataclass(frozen=True)
class ImplicitConfig:
    grid: GridSpec
    dt: float
    p2c: float
    tol: float = 1e-3  # on ||Es - Eh||^2 (pypic.py:859)
    maxiter: int = 20  # pypic.py:860
    deposit_method: str = "auto"
    tracer: int = 0  # tracer particle index for trajectory diagnostics
    # 'fused' runs each Picard inner pass as one particle sweep
    # (ops.picard: gather + CN push + half-step deposit) and honours every
    # finalize / finalize_field mode; 'composed' assembles the reference's
    # loop body from individual ops and returns its last iterate (works
    # with per-particle q/m arrays, e.g. the gen-1 electron+ion two-stream,
    # PIC_L.py:339). 'auto' = fused when q/m are scalars.
    backend: str = "auto"
    # Binomial smoothing of the gathered field guess and of the Ampere
    # current (pypic.py:261, 283). The gen-1 implicit engine runs the same
    # scheme unsmoothed (PIC_L.py:472, 502); set False for that variant.
    smooth: bool = True
    # Mesh axis for data-parallel particles (None = single device). When set,
    # the step runs under shard_map with particle arrays sharded and fields
    # replicated: deposits are reduced with psum over the axis, keeping the
    # field solve replicated and bitwise identical across shards (see
    # pypic_tpu.parallel.dataparallel).
    axis_name: str | None = None
    # Initial guess for the Picard half-step field iterate:
    #   'field'        — es0 = E0, the reference's start (pypic.py:253);
    #   'extrapolate'  — es0 = E0 + (E0 - E_prev)/2, the linear prediction of
    #     E at t + dt/2. Same fixed point and tolerance — purely a solver
    #     accelerant (~1 fewer Picard iteration per step once the field
    #     evolves smoothly, ~25% at tol=1e-9 on the 1e8 headline);
    #   'extrapolate2' — quadratic prediction through (E_prev2, E_prev, E0)
    #     evaluated at t + dt/2: (15 E0 - 10 E_prev + 3 E_prev2)/8.
    picard_init: str = "field"
    # What the step returns after the Picard loop exits (backend='fused'):
    #   'converged' (default) — recompute (p1, v1) with one extra fused sweep
    #     from the *converged* half-step field: a strictly tighter fixed-point
    #     evaluation than the reference (measured 10x better energy drift on
    #     the violent headline workload, PERF.md). The finalize sweep skips
    #     the purely-diagnostic full-step current deposit: state.j holds the
    #     half-step current jh that drove the Ampere advance, and the skipped
    #     deposit's exact grid mean still feeds the current_bias metric
    #     (periodic CIC tent weights sum to 1, so mean = w sum(v1)/ng);
    #   'converged-deposit' — same, plus the true full-step j1 deposit into
    #     state.j (one more tent build in the finalize sweep);
    #   'iterate'   — the reference's semantics (pypic.py:293-295): return
    #     the LAST Picard iterate's (p1, v1), reconstructed elementwise from
    #     the iterate's v1 (p1 = p0 + dt/dx * (v0+v1)/2) — no extra particle
    #     sweep, fastest, but carries the reference's own last-iterate
    #     consistency bias (~-1.1e-2 per 1e4 steps on the violent headline
    #     workload vs ~-2e-3 'converged' at tol 1e-9; PERF.md drift table).
    finalize: str = "converged"
    # Picard iterate update:
    #   'none'     — plain fixed-point es <- eh (the reference);
    #   'anderson' — Anderson(1) secant mixing on the field iterate: same
    #     fixed point, typically fewer iterations at tight tolerances. O(ng)
    #     extra work per iteration. The residual test stays on the unmixed
    #     ||es - eh||^2 so the tolerance means the same thing.
    #   'damped'   — under-relaxed es <- (es + eh)/2: same fixed point;
    #     counters the Picard spiral's alternation bias (the fixed-odd-count
    #     drift resonance, PERF.md) by exiting on a two-history average.
    picard_accel: str = "none"
    # Field the finalize sweep gathers with (fused backend, finalize !=
    # 'iterate'):
    #   'last'  — the final Picard ITERATE es (round-2 behavior). Under
    #     picard_accel='none' this equals the latest map output eh_k; under
    #     Anderson mixing it is the secant-accelerated fixed-point estimate;
    #   'mean2' — (eh_k + eh_{k-1})/2: averaging consecutive map outputs
    #     cancels the first-order component of the Picard spiral around the
    #     fixed point (measured: does NOT cure the fixed-odd-count drift
    #     resonance, PERF.md);
    #   'map'   — the raw last map output eh_k = (e0 + e1)/2 exactly: the
    #     unique choice consistent with the Ampere advance that produced
    #     state.e, so the finalize velocity update uses the same field whose
    #     current actually advanced the energy bookkeeping;
    #   'aitken' — scalar-secant Aitken Δ² extrapolation of the last three
    #     map outputs toward the fixed point: with the contraction factor
    #     ρ = <Δ1,Δ2>/<Δ2,Δ2> estimated per step, ef = eh_k + ρ/(1−ρ) Δ1.
    #     Generalizes 'mean2' (which assumes ρ = −1); targets the
    #     alternation bias behind the fixed-odd-count resonance without
    #     assuming its ratio. Falls back to eh_k while fewer than three map
    #     outputs exist or when ρ is out of its trust region.
    finalize_field: str = "last"
    # Implementation of the fused Picard pass (ops.picard): 'xla' | 'triton'
    # | 'auto' (the platform module's measured choice, pypic_tpu.platform).
    picard_impl: str = "auto"

    def __post_init__(self):
        # numpy scalars are not weakly typed and would promote float32 state.
        object.__setattr__(self, "dt", float(self.dt))
        object.__setattr__(self, "p2c", float(self.p2c))
        object.__setattr__(self, "tol", float(self.tol))
        object.__setattr__(self, "maxiter", int(self.maxiter))
        if self.picard_init not in ("field", "extrapolate", "extrapolate2"):
            raise ValueError(f"unknown picard_init {self.picard_init!r}")
        if self.finalize not in ("converged", "converged-deposit", "iterate"):
            raise ValueError(f"unknown finalize {self.finalize!r}")
        if self.picard_accel not in ("none", "anderson", "anderson2", "damped"):
            raise ValueError(f"unknown picard_accel {self.picard_accel!r}")
        if self.finalize_field not in ("last", "mean2", "map", "aitken"):
            raise ValueError(f"unknown finalize_field {self.finalize_field!r}")
        if self.finalize == "iterate" and self.finalize_field != "last":
            raise ValueError(
                "finalize='iterate' has no finalize sweep to redirect — "
                f"finalize_field={self.finalize_field!r} would be silently "
                "ignored; use finalize='converged' (or finalize_field='last')"
            )
        if self.backend not in ("auto", "fused", "composed"):
            raise ValueError(f"unknown backend {self.backend!r}")


class ImplicitState(PyTreeNode):
    p: jax.Array  # (n,) positions in grid coordinates
    v: jax.Array  # (n,) velocities [m/s]
    q: jax.Array  # () or (n,) charge [C]
    m: jax.Array  # () or (n,) mass [kg]
    e: jax.Array  # (ng,) electric field [V/m]
    # (ng,) current density [A/m^2]. Semantics depend on cfg.finalize: under
    # the default 'converged' (and 'iterate') this is the HALF-step current
    # jh that drove the Ampere advance (pypic.py:283); only
    # 'converged-deposit' stores the reference's full-step j1.
    j: jax.Array
    e_prev: jax.Array  # (ng,) previous-step field (picard_init='extrapolate')
    e_prev2: jax.Array  # (ng,) field two steps back (picard_init='extrapolate2')
    step: jax.Array  # () int32


class StepMetrics(NamedTuple):
    field_energy: jax.Array  # sum(eps0 E^2 dx / 2) (pypic.py:571)
    kinetic_energy: jax.Array  # p2c sum(m v^2 / 2) (pypic.py:572)
    current_bias: jax.Array  # <j> (pypic.py:574)
    picard_iters: jax.Array  # int32
    picard_residual: jax.Array
    tracer_x: jax.Array  # grid coords
    tracer_v: jax.Array


def init_state(x, v, q, m, cfg: ImplicitConfig, dtype=jnp.float32) -> ImplicitState:
    """Initial state incl. the initial Poisson solve for E0 and current j0
    (pypic.py:549-554)."""
    grid = cfg.grid
    ng = grid.ng
    dx = grid.dx
    p = (jnp.asarray(x) / grid.dx).astype(dtype)
    v = jnp.asarray(v, dtype)
    q = jnp.asarray(q, dtype)
    m = jnp.asarray(m, dtype)
    w = jnp.broadcast_to(q * (cfg.p2c / dx), p.shape).astype(dtype)
    rho0 = deposit(p, w, ng, periodic=True, method=cfg.deposit_method)
    j0 = deposit(p, w * v, ng, periodic=True, method=cfg.deposit_method)
    phi0 = solve_periodic_neutralized(rho0, dx)
    phi0 = phi0 - jnp.max(phi0)
    e0 = -grad_periodic(phi0, dx)
    return ImplicitState(
        p=p, v=v, q=q, m=m, e=e0.astype(dtype), j=j0.astype(dtype),
        e_prev=e0.astype(dtype), e_prev2=e0.astype(dtype),
        step=jnp.asarray(0, jnp.int32),
    )


def make_step(cfg: ImplicitConfig):
    """Build the jittable implicit step: state -> (state, StepMetrics)."""
    grid = cfg.grid
    ng = grid.ng
    dx = grid.dx
    dt = cfg.dt
    dt_dx = dt / dx
    inv_dx = 1.0 / dx
    method = cfg.deposit_method

    def _smooth(f):
        return smooth_periodic(f) if cfg.smooth else f

    def _allreduce(x):
        """Sum partial grid deposits / scalar reductions across the particle
        shards (no-op single-device)."""
        return lax.psum(x, cfg.axis_name) if cfg.axis_name else x

    def _from_shard0(x):
        """Pick shard 0's value for per-particle diagnostics (the tracer
        particle lives in shard 0 under data-parallel sharding)."""
        if not cfg.axis_name:
            return x
        idx = lax.axis_index(cfg.axis_name)
        return lax.psum(jnp.where(idx == 0, x, jnp.zeros_like(x)), cfg.axis_name)

    def _es0(state):
        """Initial Picard iterate (see ImplicitConfig.picard_init)."""
        if cfg.picard_init == "extrapolate":
            return state.e + 0.5 * (state.e - state.e_prev)
        if cfg.picard_init == "extrapolate2":
            return 0.125 * (15.0 * state.e - 10.0 * state.e_prev
                            + 3.0 * state.e_prev2)
        return state.e

    accel = cfg.picard_accel

    def _mix(es, eh, k, aux):
        """Next Picard iterate from the map output eh (Anderson secant
        mixing when enabled — same fixed point; see ops.accel)."""
        from ..ops.accel import anderson2_mix, anderson_mix, damped_mix

        # fields are replicated under data-parallel sharding, so the inner
        # products need no psum
        if accel == "anderson":
            return anderson_mix(es, eh, k, aux)
        if accel == "anderson2":
            return anderson2_mix(es, eh, k, aux)
        if accel == "damped":
            return damped_mix(es, eh, k, aux)
        return eh, aux

    def _mix_init(e0):
        from ..ops.accel import mix_init

        return mix_init(e0, accel)

    def step_fused(state: ImplicitState):
        """Fused Picard: one particle sweep (``ops.picard.picard_pass``) per
        inner iteration.

        finalize='converged' refines the composed path: the final
        (p1, v1, j1) are recomputed from the *converged* half-step field
        with one extra sweep — a strictly tighter fixed-point evaluation
        within the same tolerance. finalize='iterate' returns the last
        Picard iterate like the reference (pypic.py:293-295), with (p1, v1)
        reconstructed elementwise from the iterate's full-step velocity —
        no extra sweep.
        """
        p0, v0, e0 = state.p, state.v, state.e
        # q/m are scalars on this path (checked by the dispatcher below).
        qm_s = state.q / state.m
        w_s = state.q * (cfg.p2c * inv_dx)
        emit_v = cfg.finalize == "iterate"
        impl = platform.picard_impl(p0.shape[0], cfg.picard_impl)
        sweep = dict(qm=qm_s, dt=dt, dx=dx, impl=impl, method=method)

        def cond(c):
            return (c["r"] > cfg.tol) & (c["k"] < cfg.maxiter)

        def body(c):
            es = c["es"]
            outs = picard_pass(_smooth(es), c["ps"], p0, v0, ng, w=w_s,
                               emit_v=emit_v, **sweep)
            jh = _allreduce(outs[-1])
            e1 = e0 + (dt / EPSILON_0) * (jnp.mean(jh) - _smooth(jh))
            eh = 0.5 * (e1 + e0)
            r = jnp.sum((es - eh) ** 2)
            es_next, aux = _mix(es, eh, c["k"], c["aux"])
            nxt = dict(c, es=es_next, ps=outs[0], e1=e1, r=r, k=c["k"] + 1,
                       aux=aux)
            if keep_eh2:
                nxt["ehpp"] = c["ehp"]
            if keep_eh:
                nxt["ehp"], nxt["eh"] = c["eh"], eh
            if keep_jh:
                nxt["jh"] = jh
            if emit_v:
                nxt["v1"] = outs[1]
            return nxt

        keep_jh = cfg.finalize in ("iterate", "converged")
        # finalize_field='mean2' needs the last two Picard map outputs
        # (eh_k, eh_{k-1}) in the carry — the finalize sweep then gathers
        # with their average, cancelling the first-order component of the
        # Picard spiral around the fixed point (the alternation bias behind
        # the fixed-odd-count drift resonance, PERF.md).
        keep_eh = (cfg.finalize_field in ("mean2", "map", "aitken")
                   and not emit_v)
        keep_eh2 = cfg.finalize_field == "aitken" and not emit_v
        es0 = _es0(state)
        c0 = {
            "es": es0,
            "ps": p0,  # the reference's first gather position (pypic.py:253)
            "e1": e0,
            "r": jnp.asarray(jnp.inf, e0.dtype),
            "k": jnp.asarray(0, jnp.int32),
            "aux": _mix_init(e0),
        }
        if keep_eh:
            c0["eh"] = es0
            c0["ehp"] = es0
        if keep_eh2:
            c0["ehpp"] = es0
        if keep_jh:
            c0["jh"] = state.j
        if emit_v:
            c0["v1"] = v0
        c = lax.while_loop(cond, body, c0)
        e1, r, k = c["e1"], c["r"], c["k"]
        # Field the finalize sweep evaluates the converged update with.
        # mean2 averages the last two Picard MAP OUTPUTS — at k == 1 there
        # is only one (ehp still holds the seed es0, which under
        # picard_init='extrapolate' is a prediction, not a map output), so
        # fall back to the single output rather than bias toward the seed.
        # aitken likewise needs three map outputs before the Δ² model is
        # meaningful; outside its trust region it falls back to eh_k.
        if not keep_eh:
            ef = c["es"]
        elif cfg.finalize_field == "map":
            ef = c["eh"]
        elif cfg.finalize_field == "mean2":
            ef = jnp.where(c["k"] > 1, 0.5 * (c["eh"] + c["ehp"]), c["eh"])
        else:  # 'aitken'
            d1 = c["eh"] - c["ehp"]
            d2 = c["ehp"] - c["ehpp"]
            den = jnp.sum(d2 * d2)
            rho = jnp.sum(d1 * d2) / jnp.where(den > 0.0, den, 1.0)
            rho = jnp.clip(rho, -0.95, 0.95)
            trust = (c["k"] > 2) & (den > 0.0)
            corr = (rho / (1.0 - rho)) * d1
            ef = c["eh"] + jnp.where(trust, corr, jnp.zeros_like(corr))

        if emit_v:
            v1 = c["v1"]
            # p1 of the same iterate: qm dt^2/2 e_p == dt/dx * (v1 - v0)/2,
            # so p1 = p0 + dt/dx (v0 + v1)/2 (pypic.py:264, re-associated).
            p1 = p0 + (0.5 * dt_dx) * (v0 + v1)
            p1 = p1 - jnp.floor(p1 * (1.0 / ng)) * ng
            j1 = c["jh"]  # half-step current that drove the Ampere advance
            # Exact grid mean of the skipped full-step deposit: periodic CIC
            # tent weights sum to 1, so mean(deposit(p1, w v1)) == w sum(v1)/ng.
            current_bias = (w_s / ng) * _allreduce(jnp.sum(v1))
        elif cfg.finalize == "converged":
            p1, v1 = picard_finalize(_smooth(ef), c["ps"], p0, v0, ng,
                                     **sweep)
            j1 = c["jh"]
            current_bias = (w_s / ng) * _allreduce(jnp.sum(v1))
        else:  # 'converged-deposit'
            p1, v1, j1 = picard_finalize(_smooth(ef), c["ps"], p0, v0, ng,
                                         w=w_s, **sweep)
            j1 = _allreduce(j1)
            current_bias = jnp.mean(j1)

        metrics = StepMetrics(
            field_energy=0.5 * EPSILON_0 * dx * jnp.sum(e1 * e1),
            kinetic_energy=_allreduce(0.5 * cfg.p2c * jnp.sum(state.m * v1 * v1)),
            current_bias=current_bias,
            picard_iters=k,
            picard_residual=r,
            tracer_x=_from_shard0(p1[cfg.tracer]),
            tracer_v=_from_shard0(v1[cfg.tracer]),
        )
        new_state = state.replace(p=p1, v=v1, e=e1, j=j1, e_prev=state.e,
                                  e_prev2=state.e_prev, step=state.step + 1)
        return new_state, metrics

    def step(state: ImplicitState):
        scalar_qm = jnp.ndim(state.q) == 0 and jnp.ndim(state.m) == 0
        if cfg.backend == "fused" and not scalar_qm:
            raise ValueError(
                "backend='fused' requires scalar q/m (the fused pass bakes "
                "them into kernel scalars); use backend='composed' or "
                "'auto' for per-particle q/m arrays")
        if cfg.backend == "fused" or (cfg.backend == "auto" and scalar_qm):
            return step_fused(state)
        return step_composed(state)

    def step_composed(state: ImplicitState):
        """Op-composed step (per-particle q/m capable). Always returns the
        last Picard iterate and deposits j1 every iteration, exactly like
        the reference loop body (pypic.py:274-295) — cfg.finalize only
        affects the fused path."""
        p0, v0, e0 = state.p, state.v, state.e
        qm = state.q / state.m
        w = state.q * (cfg.p2c * inv_dx)  # deposit prefactor q p2c / dx

        def cond(carry):
            _, _, _, _, _, r, k, _ = carry
            return (r > cfg.tol) & (k < cfg.maxiter)

        def body(carry):
            es, ps, _, _, _, _, k, aux = carry
            # Gather smoothed field guess at position guess (pypic.py:261).
            e_p = gather(_smooth(es), ps, periodic=True)
            # Crank-Nicolson update (pypic.py:264-265), in grid coords.
            accel = qm * e_p
            p1 = p0 + dt_dx * v0 + (0.5 * dt * dt_dx) * accel
            v1 = v0 + dt * accel
            # Half-step quantities + periodic wrap (pypic.py:267-272).
            ph = jnp.mod(0.5 * (p0 + p1), ng)
            vh = 0.5 * (v0 + v1)
            jh = _allreduce(deposit(ph, jnp.broadcast_to(w, ph.shape) * vh, ng,
                                    periodic=True, method=method))
            p1 = jnp.mod(p1, ng)
            j1 = _allreduce(deposit(p1, jnp.broadcast_to(w, p1.shape) * v1, ng,
                                    periodic=True, method=method))
            # Ampere advance + half-step field (pypic.py:283-285).
            e1 = e0 + (dt / EPSILON_0) * (jnp.mean(jh) - _smooth(jh))
            eh = 0.5 * (e1 + e0)
            r = jnp.sum((es - eh) ** 2)
            es_next, aux = _mix(es, eh, k, aux)
            return es_next, ph, (p1, v1), e1, j1, r, k + 1, aux

        carry0 = (
            _es0(state),
            p0,
            (p0, v0),
            e0,
            state.j,
            jnp.asarray(jnp.inf, e0.dtype),
            jnp.asarray(0, jnp.int32),
            _mix_init(e0),
        )
        _, _, (p1, v1), e1, j1, r, k, _ = lax.while_loop(cond, body, carry0)

        metrics = StepMetrics(
            field_energy=0.5 * EPSILON_0 * dx * jnp.sum(e1 * e1),
            kinetic_energy=_allreduce(0.5 * cfg.p2c * jnp.sum(state.m * v1 * v1)),
            current_bias=jnp.mean(j1),
            picard_iters=k,
            picard_residual=r,
            tracer_x=_from_shard0(p1[cfg.tracer]),
            tracer_v=_from_shard0(v1[cfg.tracer]),
        )
        new_state = state.replace(p=p1, v=v1, e=e1, j=j1, e_prev=state.e,
                                  e_prev2=state.e_prev, step=state.step + 1)
        return new_state, metrics

    return step

