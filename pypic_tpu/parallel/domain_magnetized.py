"""Domain-decomposed magnetized Boltzmann-electron sheath engine.

Slab-shards the gen-4 pic_iead cycle (pygcpic.py:1200-1294, rebuilt in
``pypic_tpu.engines.magnetized``) over a 1D device mesh — the round-2
review's stretch item (a slab-sharded Boltzmann grid; every reference
config runs ng <= 800, so this is a scaling capability, not a bench row):

* ion charge/number densities deposit on extended slabs and halo-fold to
  their owners exactly as in ``parallel.domain_implicit``; the adaptive
  Boltzmann reference-density update (pygcpic.py:889-904) reduces its
  integrals with psums (the trapezoid end-weights live on the end shards);
* the Newton-Boltzmann solve stays SLAB-SHARDED through every iteration:
  the residual build uses one-node halo exchanges and the tridiagonal
  Newton step solves with runtime-coefficient Schur-complement
  substructuring (``make_distributed_tridiag_chain`` — one local 3-RHS
  tridiag + a (2D, 2D) interface solve per iteration, O(ng/D) work and
  O(D) comm; the Jacobian's diagonal changes every iteration so the
  baked-constant boundary responses of the explicit path don't apply);
* Dirichlet walls live on the end shards (chain halos, zero at the ends);
  wall-impact IEAD histograms accumulate into a replicated state with
  psum'd per-shard updates (pygcpic.py:1239-1262);
* MCC ionization runs shard-local on per-shard folded streams
  (pygcpic.py:350-458);
* re-activation draws are RANK-KEYED from a replicated
  ``react_batch``-sized table (the global rank = exclusive psum prefix of
  per-shard inactive counts + local rank), so draws are shard-count
  invariant; re-activated particles get fresh GLOBAL positions
  (pygcpic.py:691-720) and multi-hop migrate to their owner slab with the
  step's other boundary-crossers. Deactivated slots are parked mid-slab
  (their state is dead until re-activation).

Unsupported under slab sharding (clear errors, not silent): the
guiding-center pusher, the host-hybrid BCA impact buffer (route surface
coupling through the psum'd IEAD channel), bca_escape, and
Dirichlet-Neumann walls (the distributed rank-1 Sherman-Morrison term is
not built).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..utils.pytree import PyTreeNode
from ..constants import E_CHARGE, EPSILON_0, EV_TO_K, K_BOLTZMANN, M_ELECTRON
from ..grid import DIRICHLET_DIRICHLET, GridSpec
from ..ops import deposit, gather
from ..ops.poisson import _EXP_CLAMP, _safe_exp
from ..ops.ionization import attempt_ionization, rate_matrix
from ..push import boris_push_dt
from ..engines.magnetized import (
    SourceSpec, boltzmann_n0_update, iead_update, mirror_gather_position,
)
from .. import sources
from .domain import (
    distribute_by_slab, halo_extend, halo_fold, migrate, ring_perms,
)
from .distributed_poisson import make_distributed_tridiag_chain

shard_map = jax.shard_map


@dataclasses.dataclass(frozen=True)
class DomainMagnetizedConfig:
    grid: GridSpec  # 'dirichlet-dirichlet'; ng must divide by num_shards
    dt: float
    te: float  # electron temperature [K]
    b: Tuple[float, float, float]  # magnetic field [T]
    species_z: Tuple[int, ...]
    num_shards: int
    smooth_rho: bool = False
    newton_tol: float = 1e-9  # pygcpic.py:1022
    newton_maxiter: int = 1000
    ionization: bool = False
    max_charge_state: int = 3
    reactivate: str = "none"  # 'source' | 'capped-source' | 'flux' | 'none'
    source: Optional[SourceSpec] = None
    source_n: int = 0
    # rank-keyed re-activation table size (engines.magnetized.react_batch):
    # REQUIRED > 0 whenever reactivate != 'none' — the slab engine only
    # implements the rank-keyed draw (a full-capacity draw would have to be
    # keyed on migrating slot identities to stay shard-invariant)
    react_batch: int = 4096
    # re-activation timing (engines.magnetized.react_timing): 'reference'
    # = slots inactive at step start (the reference's one-weighting limbo,
    # pygcpic.py:1249-1254); 'immediate' = slots lost this step included
    react_timing: str = "reference"
    flux_limit: int = 0
    flux_gamma: float = 0.0
    flux_vx_pert: float = 0.0
    iead_bins: Tuple[int, int] = (40, 40)
    iead_energy_max: float = 0.0  # [eV]; 0 disables IEAD accumulation
    iead_angle_max: float = 90.0
    eta_in_volts: bool = False  # see engines.magnetized (pygcpic.py:890)
    # 'reference' reproduces the swapped-intra-cell-weight Dirichlet E
    # gather (pygcpic.py:343-347 — see engines.magnetized.gather_weights);
    # 'cic' is the corrected standard interpolation.
    gather_weights: str = "reference"
    deposit_method: str = "auto"
    halo: int = 2  # max intra-step excursion, cells
    migrate_cap: int = 4096
    axis_name: str = "slabs"
    # Newton solver: 'distributed' = slab-sharded substructured Newton (the
    # point of this module); 'replicated' = all_gather the densities and
    # run ops.poisson.solve_boltzmann_dirichlet replicated, slice the slab
    # (cheaper comm trade for tiny ng; equivalence anchor in tests)
    solver: str = "distributed"
    # Data-parallel axis composed WITH the slab axis on a 2D device mesh
    # (slabs x replicas, parallel.make_mesh2 — the domain_implicit
    # composition): each slab's particles split over num_replicas devices,
    # fields slab-sharded and replicated across replicas, slab deposits /
    # histograms / ledgers psum'd over the replica axis, the Newton solve
    # replicated per replica on identical inputs, ionization streams
    # folded per (slab, replica), and the rank-keyed re-activation cap
    # allocated by GLOBAL slot rank over both axes (replicated table).
    # Migration rides the slab axis within each replica.
    dp_axis_name: str | None = None
    num_replicas: int = 1

    def __post_init__(self):
        for f in ("dt", "te", "newton_tol", "flux_gamma", "flux_vx_pert",
                  "iead_energy_max", "iead_angle_max"):
            object.__setattr__(self, f, float(getattr(self, f)))
        for f in ("num_shards", "newton_maxiter", "max_charge_state",
                  "source_n", "react_batch", "flux_limit", "halo",
                  "migrate_cap"):
            object.__setattr__(self, f, int(getattr(self, f)))
        object.__setattr__(self, "b", tuple(float(v) for v in self.b))
        object.__setattr__(
            self, "species_z", tuple(int(z) for z in self.species_z))
        if self.grid.bc != DIRICHLET_DIRICHLET:
            raise ValueError(
                "the slab-sharded magnetized engine supports "
                "'dirichlet-dirichlet' walls only (the D-N Neumann row's "
                "rank-1 term has no distributed solve)"
            )
        if self.grid.ng % self.num_shards:
            raise ValueError(
                f"ng={self.grid.ng} not divisible by {self.num_shards} shards"
            )
        if self.halo + 3 > self.cells_per_shard:
            raise ValueError(
                f"halo={self.halo} too large for {self.cells_per_shard}-cell "
                "slabs (need halo + 3 <= cells_per_shard)"
            )
        if self.reactivate not in ("none", "source", "capped-source", "flux"):
            raise ValueError(f"unknown reactivate {self.reactivate!r}")
        if self.reactivate != "none" and self.react_batch <= 0:
            raise ValueError(
                "slab-sharded re-activation needs react_batch > 0 "
                "(rank-keyed draws from a replicated table)"
            )
        if self.react_timing not in ("reference", "immediate"):
            raise ValueError(f"unknown react_timing {self.react_timing!r}")
        if self.solver not in ("distributed", "replicated"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.gather_weights not in ("reference", "cic"):
            raise ValueError(f"unknown gather_weights {self.gather_weights!r}")
        object.__setattr__(self, "num_replicas", int(self.num_replicas))
        if (self.num_replicas > 1) != (self.dp_axis_name is not None):
            raise ValueError(
                "num_replicas > 1 requires dp_axis_name (and vice versa)")

    @property
    def cells_per_shard(self) -> int:
        return self.grid.ng // self.num_shards


class DomainMagnetizedState(PyTreeNode):
    p: jax.Array  # (S*cap,) GLOBAL grid coords, sharded
    y: jax.Array  # (S*cap,) [m], sharded
    z: jax.Array
    vx: jax.Array  # (S*cap,) [m/s], sharded
    vy: jax.Array
    vz: jax.Array
    m: jax.Array
    charge_state: jax.Array
    p2c: jax.Array
    species_idx: jax.Array  # int32
    t: jax.Array
    active: jax.Array  # int32 {1, 0}
    at_wall: jax.Array  # int32
    from_wall: jax.Array  # int32
    filled: jax.Array  # bool slot occupancy
    phi: jax.Array  # (ng,) slab-sharded
    phi_prev: jax.Array  # (ng,) slab-sharded (Newton warm start)
    n0: jax.Array  # () replicated
    p_old: jax.Array  # () replicated
    added: jax.Array  # () replicated
    rng: jax.Array  # replicated
    iead: jax.Array  # (S, ne, na) replicated
    step: jax.Array  # () int32


class StepMetrics(NamedTuple):
    n0: jax.Array
    phi_max: jax.Array
    newton_iters: jax.Array
    newton_residual: jax.Array
    n_active: jax.Array
    n_hit_wall: jax.Array
    n_ionized: jax.Array
    n_reactivated: jax.Array
    added: jax.Array
    rho: jax.Array  # (ng,) replicated diagnostic (all_gather)
    phi: jax.Array  # (ng,) replicated diagnostic
    n_migrated: jax.Array
    n_dropped: jax.Array


def init_state(
    x, v3, m, charge_state, p2c, species_idx, cfg: DomainMagnetizedConfig,
    seed: int = 0, capacity_factor: float = 1.5,
) -> DomainMagnetizedState:
    """Slab-distribute host arrays (mirrors engines.magnetized.init_state
    for the supported feature set; positions x in meters)."""
    grid = cfg.grid
    ng = grid.ng
    v3 = np.asarray(v3, np.float32)
    n_in = np.asarray(x).size
    zeros = np.zeros(n_in, np.float32)
    fields = [
        (np.asarray(x) / grid.dx).astype(np.float32),
        zeros, zeros,  # y, z
        v3[:, 0], v3[:, 1], v3[:, 2],
        np.asarray(m, np.float32),
        np.asarray(charge_state, np.float32),
        np.asarray(p2c, np.float32),
        np.asarray(species_idx, np.int32),
        zeros,  # t
    ]
    blocks, filled, _ = distribute_by_slab(fields, x, cfg, capacity_factor)
    if cfg.num_replicas > 1:
        # round-robin split of each slab's population over the replica axis
        # — layout (S, R, cap_r) so P((slabs, dp)) places replica r of slab
        # s on device (s, r); the per-replica capacity rounds up to 128
        # (domain_implicit.init_state's composition)
        r_tot = cfg.num_replicas
        cap_r = -(-blocks[0].shape[1] // r_tot)
        cap_r = -(-cap_r // 128) * 128

        def split(a, fill):
            out = np.full((a.shape[0], r_tot, cap_r), fill, a.dtype)
            for r in range(r_tot):
                cols = a[:, r::r_tot]
                out[:, r, : cols.shape[1]] = cols
            return out

        blocks = [split(b, 0) for b in blocks]
        filled = split(filled, False)
    n = filled.size
    flat = [jnp.asarray(b.reshape(n)) for b in blocks]
    ne, na = cfg.iead_bins
    ns = len(cfg.species_z)
    return DomainMagnetizedState(
        p=flat[0], y=flat[1], z=flat[2], vx=flat[3], vy=flat[4], vz=flat[5],
        m=flat[6], charge_state=flat[7], p2c=flat[8], species_idx=flat[9],
        t=flat[10],
        active=jnp.asarray(filled.reshape(n)).astype(jnp.int32),
        at_wall=jnp.zeros((n,), jnp.int32),
        from_wall=jnp.zeros((n,), jnp.int32),
        filled=jnp.asarray(filled.reshape(n)),
        phi=jnp.zeros((ng,), jnp.float32),
        phi_prev=jnp.zeros((ng,), jnp.float32),
        n0=jnp.asarray(0.0, jnp.float32),
        p_old=jnp.asarray(0.0, jnp.float32),
        added=jnp.asarray(0.0, jnp.float32),
        rng=jax.random.PRNGKey(seed),
        iead=jnp.zeros((ns, ne, na), jnp.float32),
        step=jnp.asarray(0, jnp.int32),
    )


def state_spec(cfg: DomainMagnetizedConfig):
    ax = cfg.axis_name
    s = P((ax, cfg.dp_axis_name)) if cfg.dp_axis_name else P(ax)
    return DomainMagnetizedState(
        p=s, y=s, z=s, vx=s, vy=s, vz=s, m=s, charge_state=s, p2c=s,
        species_idx=s, t=s, active=s, at_wall=s, from_wall=s, filled=s,
        phi=P(ax), phi_prev=P(ax), n0=P(), p_old=P(), added=P(), rng=P(),
        iead=P(), step=P(),
    )


def shard_state(state, mesh: Mesh, cfg: DomainMagnetizedConfig):
    return jax.tree.map(
        lambda leaf, sp: jax.device_put(
            leaf, jax.sharding.NamedSharding(mesh, sp)),
        state, state_spec(cfg),
    )


def _make_distributed_newton(cfg: DomainMagnetizedConfig):
    """Slab-sharded Newton-Boltzmann D-D solve: ops.poisson.
    solve_boltzmann_dirichlet semantics (pygcpic.py:1005-1053) with the
    residual on one-node halo exchanges and the tridiagonal step on the
    runtime-coefficient substructured chain solve."""
    ng = cfg.grid.ng
    c = cfg.cells_per_shard
    d_tot = cfg.num_shards
    ax = cfg.axis_name
    dx2 = cfg.grid.dx * cfg.grid.dx
    c1 = E_CHARGE / (K_BOLTZMANN * cfg.te)
    step_max = _EXP_CLAMP / c1
    perm_r, perm_l = ring_perms(d_tot, periodic=False)
    solve_chain = make_distributed_tridiag_chain(c, d_tot, ax)

    def solve(rho_own, n0, phi0_own):
        d = lax.axis_index(ax)
        gidx = d * c + jnp.arange(c, dtype=jnp.int32)
        interior = (gidx >= 1) & (gidx <= ng - 2)
        # global Dirichlet Laplacian diagonals (_dirichlet_diagonals)
        dl = jnp.where(gidx >= ng - 1, 0.0, 1.0).astype(rho_own.dtype)
        du = jnp.where(gidx <= 0, 0.0, 1.0).astype(rho_own.dtype)
        dg = jnp.where(interior, -2.0, 1.0).astype(rho_own.dtype)
        c0 = (E_CHARGE / EPSILON_0) * n0
        c2 = rho_own / EPSILON_0

        def nb_vals(phi):
            """(phi_{i-1}, phi_{i+1}) via chain halo exchange (zero ghosts
            at the chain ends — multiplied by dl/du zeros there)."""
            left_nb = lax.ppermute(phi[-1], ax, perm_r)  # from left nbr
            right_nb = lax.ppermute(phi[0], ax, perm_l)  # from right nbr
            down = jnp.roll(phi, 1).at[0].set(left_nb)
            up = jnp.roll(phi, -1).at[-1].set(right_nb)
            return down, up

        def body(carry):
            phi, _, it = carry
            expo = _safe_exp(c1 * phi)
            down, up = nb_vals(phi)
            f = dl * down + dg * phi + du * up - dx2 * c0 * expo + dx2 * c2
            f = jnp.where(interior, f, 0.0)
            ddiag = jnp.where(interior, -dx2 * c0 * c1 * expo,
                              -dx2 * c0 * c1)
            dphi = solve_chain(dl, dg + ddiag, du, f)
            dphi = jnp.clip(dphi, -step_max, step_max)
            phi = phi - dphi
            return phi, lax.psum(jnp.sum(dphi * dphi), ax), it + 1

        def cond(carry):
            _, residual, it = carry
            return (residual > cfg.newton_tol) & (it < cfg.newton_maxiter)

        # pin the warm start's wall entries to 0 (ops.poisson.
        # solve_boltzmann_dirichlet semantics: the frozen boundary rows
        # never move the walls, so an unpinned warm start would bake the
        # previous min-shift into the converged answer)
        phi0_own = jnp.where(interior, phi0_own, 0.0)
        phi, residual, it = lax.while_loop(
            cond, body,
            (phi0_own, jnp.asarray(1.0, rho_own.dtype),
             jnp.asarray(0, jnp.int32)),
        )
        phi = phi - lax.pmin(jnp.min(phi), ax)
        return phi, it, residual

    return solve


def make_step(cfg: DomainMagnetizedConfig, mesh: Mesh):
    grid = cfg.grid
    ng = grid.ng
    dx = grid.dx
    dt = cfg.dt
    cells = float(grid.num_cells)
    c = cfg.cells_per_shard
    d_tot = cfg.num_shards
    ax = cfg.axis_name
    h = cfg.halo
    hw = h + 1
    ext_n = c + 2 * hw + 1
    b3 = cfg.b
    te_volts = (cfg.te / EV_TO_K) if cfg.eta_in_volts else (cfg.te * EV_TO_K)
    ve = float(np.sqrt(8.0 / np.pi * K_BOLTZMANN * cfg.te / M_ELECTRON))
    rates = rate_matrix(cfg.species_z, cfg.te) if cfg.ionization else None
    perm_r, perm_l = ring_perms(d_tot, periodic=False)
    newton_dist = (_make_distributed_newton(cfg)
                   if cfg.solver == "distributed" else None)
    dp = cfg.dp_axis_name
    axes_all = (ax, dp) if dp else ax
    r_tot = cfg.num_replicas

    def dpsum(x):
        """Merge per-replica partials (no-op on the 1D mesh)."""
        return lax.psum(x, dp) if dp else x

    def clamp_loc(pl):
        return jnp.clip(pl, -float(h), float(c + h))

    def do_migrate(fields, filled, d):
        return migrate(
            fields, filled, d,
            ng=ng, cells_per_shard=c, num_shards=d_tot,
            cap=cfg.migrate_cap, ax=ax, periodic=False,
            # replicas must agree on the round count (domain.migrate)
            count_axes=axes_all,
        )

    def local_step(state: DomainMagnetizedState):
        d = lax.axis_index(ax)
        lo = d.astype(state.p.dtype) * c
        filled = state.filled
        key, k_ion, k_src = jax.random.split(state.rng, 3)
        # per-(slab, replica) ionization stream
        dev_idx = d * r_tot + lax.axis_index(dp) if dp else d
        k_ion = jax.random.fold_in(k_ion, dev_idx)

        is_active = filled & (state.active == 1)
        p_loc = jnp.where(filled, state.p - lo, 0.5)

        # --- deposits (pygcpic.py:841-905): rho and n on the extended slab,
        # folded to owners
        w_rho = jnp.where(
            is_active, state.charge_state * E_CHARGE * state.p2c / dx, 0.0)
        w_n = jnp.where(is_active, state.p2c / dx, 0.0)
        pc = clamp_loc(p_loc) + hw
        rho_ext = deposit(pc, w_rho, ext_n, periodic=False,
                          method=cfg.deposit_method)
        n_ext = deposit(pc, w_n, ext_n, periodic=False,
                        method=cfg.deposit_method)
        rho = dpsum(halo_fold(rho_ext, c, hw, ax, perm_r, perm_l))
        n_dens = dpsum(halo_fold(n_ext, c, hw, ax, perm_r, perm_l))

        # --- adaptive Boltzmann reference density (pygcpic.py:889-904):
        # global trapezoid/end terms via psums
        eta = jnp.exp(state.phi / te_volts)
        end_l = jnp.where(d == 0, eta[0], 0.0)
        end_r = jnp.where(d == d_tot - 1, eta[-1], 0.0)
        sums = lax.psum(
            jnp.stack([jnp.sum(eta), end_l, end_r, jnp.sum(n_dens)]), ax)
        p_new = dx * (sums[0] - 0.5 * (sums[1] + sums[2]))
        n0, p_old = boltzmann_n0_update(
            state.step, state.n0, state.p_old, state.added,
            q_new=sums[1] + sums[2], p_new=p_new,
            dt=dt, ve=ve, n_mean=sums[3] / ng,
        )
        added = jnp.zeros_like(state.added)

        if cfg.smooth_rho:
            # bounded binomial smoother (pygcpic.py:1491) with 1-node
            # halos; the global end rows keep their RAW value exactly as
            # ops.smooth_bounded does
            left_nb = lax.ppermute(rho[-1], ax, perm_r)
            right_nb = lax.ppermute(rho[0], ax, perm_l)
            down = jnp.roll(rho, 1).at[0].set(left_nb)
            up = jnp.roll(rho, -1).at[-1].set(right_nb)
            sm = 0.25 * down + 0.5 * rho + 0.25 * up
            li0 = jnp.arange(c)
            keep_raw = ((d == 0) & (li0 == 0)) | (
                (d == d_tot - 1) & (li0 == c - 1))
            rho = jnp.where(keep_raw, rho, sm)

        # --- Newton-Boltzmann solve (slab-sharded or replicated).
        # Wall-reference the warm start (engines.magnetized semantics):
        # phi_shifted - phi_shifted[wall] reconstructs the previous
        # UNSHIFTED Newton point exactly (uniform min-shift + frozen-0
        # walls); the wall value lives on shard 0 local 0 — one psum.
        gi = d * c + jnp.arange(c, dtype=jnp.int32)
        wall0 = lax.psum(
            jnp.sum(jnp.where(gi == 0, state.phi, 0.0)), ax)
        phi_warm = state.phi - wall0
        if cfg.solver == "distributed":
            phi, n_it, resid = newton_dist(rho, n0, phi_warm)
        else:
            from ..ops.poisson import solve_boltzmann_dirichlet

            rho_full = lax.all_gather(rho, ax, tiled=True)
            res = solve_boltzmann_dirichlet(
                rho_full, n0, cfg.te, dx, tol=cfg.newton_tol,
                maxiter=cfg.newton_maxiter,
                phi0=lax.all_gather(phi_warm, ax, tiled=True),
            )
            phi = lax.dynamic_slice(res.phi, (d * c,), (c,))
            n_it, resid = res.iterations, res.residual

        # --- E = -grad phi (pygcpic.py:907-937): centered interior with
        # one-node halos; one-sided first-order rows at the global walls
        left_nb = lax.ppermute(phi[-1], ax, perm_r)
        right_nb = lax.ppermute(phi[0], ax, perm_l)
        down = jnp.roll(phi, 1).at[0].set(left_nb)
        up = jnp.roll(phi, -1).at[-1].set(right_nb)
        e_own = -(up - down) * (0.5 / dx)
        li = jnp.arange(c)
        e_own = jnp.where((d == 0) & (li == 0),
                          -(up - phi) / dx, e_own)
        e_own = jnp.where((d == d_tot - 1) & (li == c - 1),
                          -(phi - down) / dx, e_own)

        # --- gather + Boris push in local coordinates
        e_ext = halo_extend(e_own, hw, ax, perm_r, perm_l)
        pg = clamp_loc(p_loc) + hw
        if cfg.gather_weights == "reference":
            # reference quirk: swapped intra-cell gather weights (the
            # integer +hw shift preserves the intra-cell fraction, so the
            # local-frame mirror equals the global one)
            pg = mirror_gather_position(pg, float(ext_n - 1))
        e_p = jnp.where(
            is_active, gather(e_ext, pg, periodic=False),
            0.0,
        )
        x_si = p_loc * dx
        yz = jnp.stack([state.y, state.z], axis=-1)
        v3 = jnp.stack([state.vx, state.vy, state.vz], axis=-1)
        x1, yz1, v1 = boris_push_dt(
            x_si, yz, v3, e_p, jnp.asarray(b3, jnp.float32),
            state.charge_state, state.m, dt,
        )
        p1 = jnp.where(is_active, x1 / dx, p_loc)
        y1 = jnp.where(is_active, yz1[:, 0], state.y)
        z1 = jnp.where(is_active, yz1[:, 1], state.z)
        vx1 = jnp.where(is_active, v1[:, 0], state.vx)
        vy1 = jnp.where(is_active, v1[:, 1], state.vy)
        vz1 = jnp.where(is_active, v1[:, 2], state.vz)
        t1 = jnp.where(is_active, state.t + dt, state.t)

        # --- Dirichlet walls on GLOBAL coordinates (pygcpic.py:668-689)
        p1_g = p1 + lo
        hit = is_active & ((p1_g < 0.0) | (p1_g > cells))
        active = jnp.where(hit, 0, state.active)
        at_wall = jnp.where(hit, 1, state.at_wall)

        # --- IEAD histograms (replicated state += psum'd updates; the
        # binning quirks live in the single-device engine's shared helper)
        iead = state.iead
        if cfg.iead_energy_max > 0.0:
            iead = iead_update(
                iead, state.species_idx, state.m, vx1, vy1, vz1, hit,
                bins=cfg.iead_bins, energy_max=cfg.iead_energy_max,
                angle_max=cfg.iead_angle_max,
                deposit_method=cfg.deposit_method,
                allreduce=lambda u: lax.psum(u, axes_all),
            )

        # --- MCC ionization (pygcpic.py:1510-1513), shard-local
        n_ionized = jnp.asarray(0, jnp.int32)
        charge_state = state.charge_state
        if cfg.ionization:
            still_active = filled & (active == 1)
            n_loc = jnp.where(
                still_active,
                gather(halo_extend(n_dens, hw, ax, perm_r, perm_l),
                       clamp_loc(p1) + hw, periodic=False),
                0.0,
            )
            charge_state, ionized, added_ion = attempt_ionization(
                k_ion, n_loc, charge_state, state.species_idx, state.p2c,
                rates, dx, dt, still_active,
                max_charge_state=cfg.max_charge_state,
            )
            added = added + added_ion
            n_ionized = lax.psum(jnp.sum(ionized.astype(jnp.int32)),
                                 axes_all)

        # --- rank-keyed re-activation from a replicated table
        n_react = jnp.asarray(0, jnp.int32)
        m_arr, p2c_arr, sp_arr = state.m, state.p2c, state.species_idx
        fw = state.from_wall
        if cfg.reactivate != "none":
            src = cfg.source
            nb = cfg.react_batch
            # 'reference' timing: slots inactive at step START — a slot
            # lost during this step's push waits one step, matching the
            # reference's else-branch limbo (engines.magnetized.react_timing)
            inactive = filled & ((state.active != 1)
                                 if cfg.react_timing == "reference"
                                 else (active != 1))
            rank = jnp.cumsum(inactive.astype(jnp.int32)) - 1
            n_inact = jnp.sum(inactive.astype(jnp.int32))
            counts = lax.all_gather(n_inact, axes_all)
            before = jnp.sum(jnp.where(
                jnp.arange(counts.shape[0]) < dev_idx, counts, 0))
            rank = rank + before  # global rank over (slab, replica) devices
            if cfg.reactivate == "flux":
                batch = sources.sample_flux_6d(
                    k_src, nb, grid, src.ti, src.mass, vx=src.vx,
                    gamma=cfg.flux_gamma, vx_pert=cfg.flux_vx_pert,
                    components=True,
                )
                batch["vx"] = -jnp.abs(batch["vx"])  # pygcpic.py:2059
                take = inactive & (rank < min(cfg.flux_limit, nb))
            else:
                batch = sources.sample_source_6d(
                    k_src, nb, grid, src.ti, src.mass, vx=src.vx,
                    components=True,
                )
                if cfg.reactivate == "capped-source":
                    n_src_active = lax.psum(jnp.sum(
                        (filled & (active == 1)
                         & (state.species_idx == src.species_idx)
                         & (charge_state > 0)).astype(jnp.int32)), axes_all)
                    deficit = jnp.maximum(cfg.source_n - n_src_active, 0)
                    take = inactive & (rank < jnp.minimum(deficit, nb))
                else:
                    take = inactive & (rank < nb)
            idx = jnp.clip(rank, 0, nb - 1)
            bx_g = jnp.take(batch["x"], idx) / dx  # GLOBAL grid coords
            bvx = jnp.take(batch["vx"], idx)
            bvy = jnp.take(batch["vy"], idx)
            bvz = jnp.take(batch["vz"], idx)
            # re-activated slots get GLOBAL positions; the migration below
            # routes them to their owner slab
            p1_g = jnp.where(take, bx_g, jnp.where(is_active | hit, p1_g,
                                                   lo + 0.5))
            y1 = jnp.where(take, 0.0, y1)
            z1 = jnp.where(take, 0.0, z1)
            vx1 = jnp.where(take, bvx, vx1)
            vy1 = jnp.where(take, bvy, vy1)
            vz1 = jnp.where(take, bvz, vz1)
            m_arr = jnp.where(take, src.mass, m_arr)
            charge_state = jnp.where(take, src.charge_state, charge_state)
            p2c_arr = jnp.where(take, src.p2c, p2c_arr)
            sp_arr = jnp.where(take, src.species_idx, sp_arr)
            t1 = jnp.where(take, state.step.astype(t1.dtype) * dt, t1)
            active = jnp.where(take, 1, active)
            at_wall = jnp.where(take, 0, at_wall)
            fw = jnp.where(take, 0, fw)
            n_react = lax.psum(jnp.sum(take.astype(jnp.int32)), axes_all)
            added = added + (2.0 * src.p2c) * jnp.sum(take.astype(added.dtype))
        else:
            # park deactivated slots mid-slab so they never migrate
            p1_g = jnp.where(is_active | hit, p1_g, lo + 0.5)

        # parked (inactive) slots must not migrate: pin them mid-slab
        p_mig = jnp.where(filled & (active == 1), p1_g, lo + 0.5)
        active_f = active.astype(jnp.float32)
        at_wall_f = at_wall.astype(jnp.float32)
        fw_f = fw.astype(jnp.float32)
        (p2, y2, z2, vx2, vy2, vz2, m2, cs2, p2c2, sp2, t2, act2f, aw2f,
         fw2f), filled, n_mig, n_drop = do_migrate(
            [p_mig, y1, z1, vx1, vy1, vz1, m_arr, charge_state, p2c_arr,
             sp_arr.astype(jnp.float32), t1, active_f, at_wall_f, fw_f],
            filled, d,
        )
        active2 = act2f.astype(jnp.int32)

        added = lax.psum(added, axes_all)
        rho_full = lax.all_gather(rho, ax, tiled=True)
        phi_full = lax.all_gather(phi, ax, tiled=True)
        metrics = StepMetrics(
            n0=n0,
            phi_max=jnp.max(phi_full),
            newton_iters=n_it,
            newton_residual=resid,
            n_active=lax.psum(
                jnp.sum((filled & (active2 == 1)).astype(jnp.int32)),
                axes_all),
            n_hit_wall=lax.psum(jnp.sum(hit.astype(jnp.int32)), axes_all),
            n_ionized=n_ionized,
            n_reactivated=n_react,
            added=added,
            rho=rho_full,
            phi=phi_full,
            n_migrated=dpsum(n_mig),
            n_dropped=dpsum(n_drop),
        )
        new_state = state.replace(
            p=p2, y=y2, z=z2, vx=vx2, vy=vy2, vz=vz2, m=m2,
            charge_state=cs2, p2c=p2c2, species_idx=sp2.astype(jnp.int32),
            t=t2, active=active2, at_wall=aw2f.astype(jnp.int32),
            from_wall=fw2f.astype(jnp.int32), filled=filled,
            phi=phi, phi_prev=state.phi, n0=n0, p_old=p_old, added=added,
            rng=key, iead=iead, step=state.step + 1,
        )
        return new_state, metrics

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
