"""Explicit periodic electrostatic PIC engine (leapfrog).

The standard explicit PIC cycle — deposit rho -> Poisson -> E -> gather ->
leapfrog push -> periodic wrap — as one jitted step function. Reproduces the
gen-1 explicit driver (PIC_L.py:604-786 ``main``, cycle at 762-768) and the
*intended* behavior of the bit-rotted gen-3 ``explicit_pic``
(pypic.py:711-731; dead code in the reference, SURVEY.md §2.1).

Diagnostics use the physical definitions — field energy with the dx measure
and kinetic energy with one power of p2c and the per-particle mass — rather
than the dead driver's inconsistent ``p2c**2`` / measure-free expressions
(pypic.py:733-734), so energy-conservation acceptance tests are meaningful.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.pytree import PyTreeNode
from ..constants import EPSILON_0
from ..grid import GridSpec
from ..ops import (
    deposit,
    gather,
    grad_periodic,
    solve_periodic_neutralized,
)
from ..push import leapfrog_push


@dataclasses.dataclass(frozen=True)
class ExplicitConfig:
    grid: GridSpec
    dt: float
    p2c: float
    deposit_method: str = "auto"
    # Data-parallel particle sharding over a 1D mesh axis (wrap make_step
    # with parallel.make_data_parallel_step): per-shard rho deposits psum
    # before the replicated Poisson solve, so the carried rho/e leaves
    # stay GLOBAL and the dp wrapper's replicated grid spec holds.
    # Spatial scaling is parallel.domain; dp is the particle-count axis.
    axis_name: str | None = None

    def __post_init__(self):
        # numpy scalars are not weakly typed and would promote float32 state.
        object.__setattr__(self, "dt", float(self.dt))
        object.__setattr__(self, "p2c", float(self.p2c))


class ExplicitState(PyTreeNode):
    p: jax.Array  # (n,) positions in grid coordinates
    v: jax.Array  # (n,) velocities [m/s]
    q: jax.Array  # () or (n,) charge [C]
    m: jax.Array  # () or (n,) mass [kg]
    rho: jax.Array  # (ng,) charge density of p — the invariant rho ==
    # deposit(p) lets the push sweep deposit its OWN output for the next
    # step's solve, making the step a single particle sweep
    e: jax.Array  # (ng,) electric field of rho (same invariant: e ==
    # solve(rho))
    step: jax.Array  # () int32


class StepMetrics(NamedTuple):
    field_energy: jax.Array  # sum(eps0 E^2 dx / 2) [J/m^2]
    kinetic_energy: jax.Array  # p2c sum(m v^2 / 2)
    current_bias: jax.Array  # <j>
    rho: jax.Array  # (ng,) for optional field diagnostics
    e_field: jax.Array  # (ng,)


def init_state(x, v, q, m, cfg: ExplicitConfig,
               dtype=jnp.float32) -> ExplicitState:
    """Wrap SI arrays from an initializer into engine state (grid coords)
    and deposit the initial charge density (state.rho must always equal
    the weighted deposit of state.p — the step's invariant)."""
    if isinstance(cfg, GridSpec):
        raise TypeError(
            "init_state now takes the ExplicitConfig (it needs p2c for the "
            "initial charge deposit), not a bare GridSpec"
        )
    grid, p2c = cfg.grid, cfg.p2c
    method = getattr(cfg, "deposit_method", "auto")
    p = (jnp.asarray(x, dtype) / jnp.asarray(grid.dx, dtype)).astype(dtype)
    v = jnp.asarray(v, dtype)
    q = jnp.asarray(q, dtype)
    m = jnp.asarray(m, dtype)
    w = jnp.broadcast_to(q * (p2c / grid.dx), p.shape).astype(dtype)
    rho = deposit(p, w, grid.ng, periodic=True, method=method)
    phi = solve_periodic_neutralized(rho, grid.dx)
    e = -grad_periodic(phi, grid.dx)
    return ExplicitState(
        p=p, v=v, q=q, m=m, rho=rho, e=e.astype(dtype),
        step=jnp.asarray(0, jnp.int32),
    )


def refresh_fields(state: ExplicitState, cfg: ExplicitConfig) -> ExplicitState:
    """Recompute the carried rho/e from state.p (restores the step
    invariant — use after loading a legacy checkpoint written before the
    fields were carried, where name-based restore falls back to the
    template's values for a DIFFERENT particle configuration)."""
    grid = cfg.grid
    w = jnp.broadcast_to(
        state.q * (cfg.p2c / grid.dx), state.p.shape
    ).astype(state.p.dtype)
    rho = deposit(state.p, w, grid.ng, periodic=True,
                  method=cfg.deposit_method)
    phi = solve_periodic_neutralized(rho, grid.dx)
    e = -grad_periodic(phi, grid.dx)
    return state.replace(rho=rho, e=e.astype(state.p.dtype))


def make_step(cfg: ExplicitConfig):
    """Build the jittable step: state -> (state, StepMetrics)."""
    grid = cfg.grid
    ng = grid.ng
    dx = grid.dx
    dt = cfg.dt
    dt_dx = dt / dx
    inv_dx = 1.0 / dx

    ax = cfg.axis_name

    def _allreduce(x):
        return lax.psum(x, ax) if ax else x

    def step(state: ExplicitState):
        qm = state.q / state.m
        # Field of the CURRENT positions: carried in state (the previous
        # step's sweep deposited rho and solved for E — pypic.py:715-719
        # as a loop-rotated invariant).
        rho, e = state.rho, state.e
        e_p = gather(e, state.p, periodic=True)
        p1, v1 = leapfrog_push(state.p, state.v, e_p, qm, dt, dt_dx)
        p1 = jnp.mod(p1, ng)
        w_rho = state.q * (cfg.p2c * inv_dx)
        rho1 = deposit(
            p1, jnp.broadcast_to(w_rho, p1.shape), ng,
            periodic=True, method=cfg.deposit_method,
        )
        rho1 = _allreduce(rho1)
        phi1 = solve_periodic_neutralized(rho1, dx)
        e1 = -grad_periodic(phi1, dx)

        # Exact grid mean of the current deposit (pypic.py:716): periodic
        # CIC tents sum to 1, so mean(deposit(p, q w v)) == sum(q w v)/ng —
        # the second full deposit sweep this metric used to cost is waste.
        current_bias = _allreduce(jnp.sum(
            jnp.broadcast_to(state.q, state.p.shape) * state.v
        ) * (cfg.p2c * inv_dx / ng))
        metrics = StepMetrics(
            field_energy=0.5 * EPSILON_0 * dx * jnp.sum(e * e),
            kinetic_energy=_allreduce(
                0.5 * cfg.p2c * jnp.sum(state.m * state.v * state.v)),
            current_bias=current_bias,
            rho=rho,
            e_field=e,
        )
        return state.replace(p=p1, v=v1, rho=rho1, e=e1.astype(p1.dtype),
                             step=state.step + 1), metrics

    return step

