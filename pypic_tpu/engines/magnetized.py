"""Magnetized Boltzmann-electron sheath engine (gen-4, pygcpic.py).

One jitted step reproducing the per-timestep cycle shared by the gen-4
drivers ``pic_iead`` (pygcpic.py:1200-1294), ``pic_bca_aps``
(pygcpic.py:1449-1632, minus the external F-TRIDYN coupling — see
pypic_tpu.bca) and ``dirichlet_neumann_test`` (pygcpic.py:2022-2090):

1. Boltzmann-weighted deposit of ion charge/number density with the adaptive
   electron reference-density update (``weight_particles_to_grid_boltzmann``,
   pygcpic.py:841-905): first step pins n0 = 0.9 <n>; later steps evolve n0
   from the potential integral p = trapz(exp(phi/Te)), the boundary factors,
   the particle-creation ledger r = 2 added/dt, and the thermal-flux factor
   fn = sqrt(ve q dt / p) exactly as pygcpic.py:889-904.
2. optional binomial rho smoothing (pygcpic.py:1491 ``smooth_rho``).
3. Newton Boltzmann Poisson solve, Dirichlet-Dirichlet or Dirichlet-Neumann
   by grid.bc (ops.poisson; reference pygcpic.py:1005-1109).
4. E = -grad phi (pygcpic.py:907-937), CIC field gather at active particles.
5. Boris-Buneman push in the constant B field (pygcpic.py:460-507).
6. Dirichlet wall deactivation (pygcpic.py:668-689) with wall-impact
   energy-angle (IEAD) histogram accumulation per species
   (pygcpic.py:1239-1262: energy in eV, angle w.r.t. the wall normal in
   degrees, pygcpic.py:228-259).
7. Monte-Carlo-collision ionization (ops.ionization; pygcpic.py:350-458).
8. Re-activation of inactive slots from the volumetric source or the wall
   flux source (pygcpic.py:691-720, 1248-1254, 2055-2060), crediting the
   particle ledger (pygcpic.py:1115-1117).

The reference's Particle-object list becomes fixed-capacity arrays; dynamic
creation/deletion is slot reuse via the active mask (SURVEY.md §7 hard part
2).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..utils.pytree import PyTreeNode
from ..constants import E_CHARGE, EPSILON_0, EV_TO_K, K_BOLTZMANN, M_ELECTRON
from ..grid import DIRICHLET_NEUMANN, GridSpec
from ..ops import (
    deposit,
    gather,
    grad_neg_bounded,
    histogram_add,
    smooth_bounded,
    solve_boltzmann_dirichlet,
    solve_boltzmann_dirichlet_neumann,
)
from ..ops.ionization import attempt_ionization, rate_matrix
from ..push import boris_push_dt
from .. import sources


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    """Species data for re-activated particles (pygcpic.py:1251 args)."""

    mass: float
    charge_state: float
    p2c: float
    species_idx: int  # row into MagnetizedConfig.species_z
    ti: float  # sampling temperature [K]
    vx: float = 0.0


@dataclasses.dataclass(frozen=True)
class MagnetizedConfig:
    grid: GridSpec  # 'dirichlet-dirichlet' or 'dirichlet-neumann'
    dt: float
    te: float  # electron temperature [K] (Boltzmann fluid + MCC background)
    b: Tuple[float, float, float]  # magnetic field [T] (pygcpic.py:1329)
    species_z: Tuple[int, ...]  # species_idx -> atomic number Z
    smooth_rho: bool = False
    newton_tol: float = 1e-9  # pygcpic.py:1022
    newton_maxiter: int = 1000  # pygcpic.py:1023
    # Newton warm start: 'previous' = the reference's warm start at the
    # last phi (pygcpic.py:1046, the default); 'extrapolate' =
    # 2 phi - phi_prev. Negative result (pic_iead at 1e6): extrapolation
    # RAISES the mean Newton count 3.4 -> 3.8 —
    # the stochastic wall-loss/re-activation noise in phi is amplified 2x
    # by the linear prediction, outweighing the quasi-steady drift it
    # tracks. Kept as an option for smooth (noise-free) configurations.
    newton_warm: str = "previous"
    ionization: bool = False
    max_charge_state: int = 3  # pygcpic.py:1512 gate; 1 == reference quirk
    reactivate: str = "none"  # 'source' | 'capped-source' | 'flux' | 'none'
    source: Optional[SourceSpec] = None
    # 'capped-source': re-activate only while the active ionized source-species
    # count is below source_n; surplus inactive slots stay free — the
    # fixed-shape equivalent of pic_bca_aps's reactivate-or-delete logic
    # (pygcpic.py:1543-1563)
    source_n: int = 0
    # RNG for the full-capacity re-activation batch (all policies):
    # 'threefry' = jax.random streams (sample_source_6d / sample_flux_6d);
    # 'hash' = counter-based murmur3 mixer + Box-Muller
    # (sources.sample_source_6d_hash / sample_flux_6d_hash — identical
    # distributions, and the only sampler whose draws are shard-count-
    # invariant under data-parallel sharding, so it is REQUIRED for
    # axis_name runs). 'auto' resolves at make_step: hash under
    # data-parallel, threefry otherwise (kept symbolic so
    # dataclasses.replace(cfg, axis_name=...) re-resolves).
    source_sampler: str = "auto"
    # Capped re-activation draw: 0 = draw a full-capacity batch every step
    # and mask in the slots that re-activate (the reference's fixed-shape
    # semantics, though only ~0.1% of slots take a draw). > 0 = draw only this many
    # samples, keyed on the slot's re-activation RANK (its order among this
    # step's inactive slots), and gather batch[rank] into the take slots —
    # at most react_batch slots re-activate per step; any surplus inactive
    # slots wait for the next step (they keep their rank order). Rank is
    # GLOBAL under data-parallel sharding, so rank-keyed draws are
    # shard-count-invariant for every sampler (the batch table is
    # replicated); the 'hash'-only dp restriction doesn't apply here.
    # Not bit-compatible with react_batch=0 (a slot's draw is keyed on rank
    # instead of slot id — identical distribution, equivalence-tested).
    react_batch: int = 0
    flux_limit: int = 0  # max re-activations/step on the 'flux' policy
    flux_gamma: float = 0.0  # perturbed-beam fraction (pygcpic.py:2008)
    flux_vx_pert: float = 0.0
    # Re-activation timing. The reference reactivates a slot in the step
    # AFTER the one that lost it: the particle loop's else branch
    # (pygcpic.py:1249-1254, 1543-1549) only reaches particles already
    # inactive when the loop starts, so a wall-lost particle sits out
    # exactly one weighting pass ("limbo") before its replacement enters
    # the dynamics, and the add_particles ledger credit lands in the
    # weighting where the replacement first deposits. 'reference'
    # (default) reproduces that: the take set is the slots inactive at
    # step START. 'immediate' reactivates slots lost during THIS step's
    # push as well (no limbo — one step earlier than the reference;
    # identical cost, identical distributions).
    react_timing: str = "reference"
    iead_bins: Tuple[int, int] = (40, 40)  # (energies, angles)
    iead_energy_max: float = 0.0  # [eV]; 0 disables IEAD accumulation
    iead_angle_max: float = 90.0
    deposit_method: str = "auto"
    # Wall-impact extraction for the BCA surface coupling (pypic_tpu.bca):
    # when > 0, each step returns up to this many (energy_eV, angle_deg,
    # species_idx) rows for particles deactivated at a wall this step —
    # the fixed-shape form of the reference's energies_*/angles_* lists
    # (pygcpic.py:1516-1527).
    impact_buffer_size: int = 0
    # pic_bca_aps deactivates wall-born (BCA-product) particles that escape
    # the sheath into the mid-domain region length/2 +/- length/8,
    # accumulating their energy-angle distribution separately
    # (pygcpic.py:1529-1541, iead_out_* at 1426-1427).
    bca_escape: bool = False
    # Hot-loop pusher: 'boris' (pygcpic.py:460-507 — what every reference
    # driver integrates with) or 'gc' — guiding-center RK4
    # (pygcpic.py:598-645) with per-particle mode as the reference's
    # Particle.mode (pygcpic.py:101): charged particles carry their guiding
    # center in (p, yz) and [v_par, mu, 0] in v (the reference's r-vector
    # packing, pygcpic.py:547-549); neutrals (BCA products) stay 6D-Boris
    # until ionization transforms them to GC. The reference defines this
    # machinery but no driver ever branches on mode or calls push_GC —
    # this engine mode is the missing consumer (BASELINE configs[3]
    # "guiding-center magnetized PIC"). 6D<->GC transforms run at the
    # boundaries: initialization, re-activation, ionization, and wall
    # impact (a random gyro-phase reconstructs the 6D velocity for
    # IEAD/impact diagnostics, pygcpic.py:553-596).
    pusher: str = "boris"
    # GC parallel acceleration: 'physical' = (q/m) E.bhat; 'reference' =
    # the literal pygcpic.py:638-639 expression (dimensionally
    # inconsistent — see push.gc_push_rk4). The engine defaults to
    # 'physical' because no reference driver integrates GC dynamics, so
    # there is no reference trajectory to reproduce; the op keeps the
    # quirk for doctest-level parity.
    gc_eom: str = "physical"
    # The reference's Dirichlet E gather SWAPS the intra-cell CIC weights
    # (pygcpic.py:343-347: w_l = frac, E = E[ind] w_l + E[ind+1] w_r —
    # inverted relative to the standard tent, and relative to the
    # reference's own deposits at pygcpic.py:858-864, which are correct).
    # Materially affects dynamics (the E draw lands on the wrong side of
    # steep sheath gradients). 'reference' (default) reproduces it by
    # gathering at the cell-mirrored position 2 floor(p) + 1 - p; 'cic' is
    # the corrected standard interpolation. Found (and pinned forever) by
    # the side-by-side golden harness, tests/test_reference_parity.py.
    gather_weights: str = "reference"
    # The reference's eta = exp(phi/Te/11600) divides by Te *in Kelvin* and
    # then by 11600 again (pygcpic.py:890, 895), i.e. eta ~ 1 everywhere —
    # and that near-unity eta is precisely what keeps its adaptive-n0
    # particle-balance feedback stable (with eta = exp(e phi / kB Te), the
    # intended expression, the feedback loop n0 -> phi -> eta -> n0 diverges
    # for these configs). Default reproduces the reference's literal formula;
    # set True for the physically-intended volts normalization.
    eta_in_volts: bool = False
    # Data-parallel particle sharding over a 1D mesh axis (shard_map via
    # parallel.dataparallel-style wrapping done by the caller, or the
    # magnetized_data_parallel helper below): deposits / histograms /
    # particle ledgers are psum-reduced, the Newton solve runs replicated
    # on the globally-summed densities, and re-activation draws are
    # shard-count-INVARIANT — the counter-based samplers offset their
    # slot ids by the shard's global position, so an 8-way sharded run
    # reproduces the single-device batch bit-for-bit, and the capped
    # policies ('capped-source'/'flux') allocate their GLOBAL caps by
    # global slot rank (exclusive prefix of per-shard inactive counts
    # over the axis + local rank — identical to the single-device slot
    # order under contiguous block sharding). Restrictions (clear errors,
    # not silent): source_sampler='hash' whenever reactivate != 'none',
    # impact_buffer_size=0 (the BCA impact buffer is a host-hybrid seam;
    # route surface coupling through the psum'd IEAD channel instead —
    # see engines.bca_driver.run_bca_iead).
    axis_name: Optional[str] = None

    def __post_init__(self):
        for f in ("dt", "te", "newton_tol", "flux_gamma", "flux_vx_pert",
                  "iead_energy_max", "iead_angle_max"):
            object.__setattr__(self, f, float(getattr(self, f)))
        object.__setattr__(self, "b", tuple(float(v) for v in self.b))
        object.__setattr__(self, "species_z", tuple(int(z) for z in self.species_z))
        if self.source_sampler not in ("auto", "hash", "threefry"):
            raise ValueError(f"unknown source_sampler {self.source_sampler!r}")
        if self.newton_warm not in ("extrapolate", "previous"):
            raise ValueError(f"unknown newton_warm {self.newton_warm!r}")
        if self.gather_weights not in ("reference", "cic"):
            raise ValueError(f"unknown gather_weights {self.gather_weights!r}")
        if self.pusher not in ("boris", "gc"):
            raise ValueError(f"unknown pusher {self.pusher!r}")
        if self.gc_eom not in ("physical", "reference"):
            raise ValueError(f"unknown gc_eom {self.gc_eom!r}")
        if self.pusher == "gc" and not any(v != 0.0 for v in self.b):
            raise ValueError("pusher='gc' requires a nonzero magnetic field")
        if self.react_batch < 0:
            raise ValueError("react_batch must be >= 0")
        if self.react_timing not in ("reference", "immediate"):
            raise ValueError(f"unknown react_timing {self.react_timing!r}")
        if self.axis_name is not None:
            if (self.react_batch == 0 and self.reactivate != "none"
                    and self.source_sampler == "threefry"):
                raise ValueError(
                    "data-parallel full-capacity re-activation needs "
                    "source_sampler='hash' (slot-offset counters give "
                    "shard-invariant draws; a replicated threefry key would "
                    "draw the SAME batch on every shard) — 'auto' resolves "
                    "to hash here, or set react_batch > 0 (rank-keyed "
                    "draws from a replicated table are shard-invariant for "
                    "every sampler)"
                )
            if self.impact_buffer_size > 0:
                raise ValueError(
                    "impact_buffer_size > 0 is not supported under "
                    "data-parallel sharding (host-hybrid BCA seam)"
                )


class MagnetizedState(PyTreeNode):
    # Coordinate meaning per particle follows ``mode`` (the reference's
    # Particle.mode, pygcpic.py:101): mode 0 — (p, yz) is the particle
    # position, v the 6D velocity; mode 1 (cfg.pusher='gc') — (p, yz) is
    # the GUIDING CENTER and v packs [v_par, mu, 0] (the reference's
    # r-vector layout in GC coordinates, pygcpic.py:547-549).
    # Lateral positions / velocities are flat (n,) leaves; the ``yz``/``v``
    # properties provide the stacked diagnostic views.
    p: jax.Array  # (n,) x in grid coordinates
    y: jax.Array  # (n,) lateral position [m]
    z: jax.Array  # (n,) lateral position [m]
    vx: jax.Array  # (n,) [m/s] (mode 1: v_par)
    vy: jax.Array  # (n,) [m/s] (mode 1: mu)
    vz: jax.Array  # (n,) [m/s] (mode 1: 0)
    m: jax.Array  # (n,) mass [kg]
    charge_state: jax.Array  # (n,) charge number (float)
    p2c: jax.Array  # (n,)
    species_idx: jax.Array  # (n,) int32 row into cfg.species_z
    t: jax.Array  # (n,) particle time [s] (pygcpic r[6])
    active: jax.Array  # (n,) int32 {1, 0}
    at_wall: jax.Array  # (n,) int32
    from_wall: jax.Array  # (n,) int32 (BCA products)
    mode: jax.Array  # (n,) int32 {0: 6D, 1: guiding-center} (pygcpic.py:101)
    phi: jax.Array  # (ng,) potential [V]
    phi_prev: jax.Array  # (ng,) previous-step potential (Newton warm start)
    n0: jax.Array  # () Boltzmann electron reference density
    p_old: jax.Array  # () previous trapz(exp(phi/Te)) (pygcpic.py:891)
    added: jax.Array  # () particle-creation ledger (pygcpic.py:1111-1117)
    rng: jax.Array
    iead: jax.Array  # (S, ne, na) wall-impact histograms per species
    iead_out: jax.Array  # (S, ne, na) sheath-escape histograms (pygcpic.py:1426)
    step: jax.Array  # () int32

    @property
    def v(self) -> jax.Array:
        """(n, 3) stacked velocity view (diagnostics/tests; not a leaf)."""
        return jnp.stack([self.vx, self.vy, self.vz], axis=-1)

    @property
    def yz(self) -> jax.Array:
        """(n, 2) stacked lateral-position view (not a leaf)."""
        return jnp.stack([self.y, self.z], axis=-1)


# old checkpoints stored stacked (n, 2)/(n, 3) leaves; split on restore
# (checkpoint.load(migrate=...), wired up by cli --resume)
CHECKPOINT_MIGRATIONS = {
    ".yz": lambda a: {".y": a[:, 0], ".z": a[:, 1]},
    ".v": lambda a: {".vx": a[:, 0], ".vy": a[:, 1], ".vz": a[:, 2]},
}


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
    rho: jax.Array  # (ng,)
    phi: jax.Array  # (ng,)
    # (impact_buffer_size, 7) rows [energy_eV, angle_deg, species_idx, side,
    # vx_over_vth, r_lateral_m, from_wall] (side: 0 = left wall, 1 = right;
    # cols 4-6 feed the write_particles event streams, pygcpic.py:1440-1527)
    # + valid count; zero-size when disabled
    impacts: jax.Array
    n_impacts: jax.Array
    n_escaped: jax.Array  # BCA products deactivated mid-domain
    # per-event sheath-escape rows [vx_over_vth, species_idx, energy_eV,
    # angle_deg] + valid count (the {source,wall}_out.dat streams,
    # pygcpic.py:1529-1541); zero-size unless impact_buffer_size > 0 AND
    # bca_escape
    escapes: jax.Array = 0
    n_escape_rows: jax.Array = 0


def _gc_pack(p, yz, v, charge_state, m, cfg: MagnetizedConfig):
    """6D (p grid-coords, yz [m], v 3-vel) -> GC packing (guiding center in
    (p, yz), [v_par, mu, 0] in v) — pygcpic.py:509-551 vectorized. Rows with
    charge_state == 0 would divide by wc = 0; callers select with a mask, so
    a safe charge floor keeps the unselected lanes finite."""
    from ..push import to_guiding_center

    dx = cfg.grid.dx
    pos = jnp.stack([p * dx, yz[:, 0], yz[:, 1]], axis=-1)
    cs_safe = jnp.where(charge_state != 0, charge_state,
                        jnp.ones_like(charge_state))
    x_gc, vpar, mu = to_guiding_center(
        pos, v, jnp.asarray(cfg.b, v.dtype), cs_safe, m,
        perp_floor=1e-30,
    )
    v_gc = jnp.stack([vpar, mu, jnp.zeros_like(vpar)], axis=-1)
    return x_gc[:, 0] / dx, x_gc[:, 1:3], v_gc


def _gc_unpack_v(key, p, yz, v_packed, charge_state, m, cfg: MagnetizedConfig):
    """GC packing -> 6D velocity with a random gyro-phase
    (pygcpic.py:553-596) for wall-impact / IEAD diagnostics."""
    from ..push import from_guiding_center

    dx = cfg.grid.dx
    pos = jnp.stack([p * dx, yz[:, 0], yz[:, 1]], axis=-1)
    cs_safe = jnp.where(charge_state != 0, charge_state,
                        jnp.ones_like(charge_state))
    _, v6 = from_guiding_center(
        key, pos, v_packed[:, 0], v_packed[:, 1],
        jnp.asarray(cfg.b, v_packed.dtype), cs_safe, m,
    )
    return v6


def init_state(
    x, v3, m, charge_state, p2c, species_idx, cfg: MagnetizedConfig,
    yz=None, seed: int = 0, dtype=jnp.float32, capacity: int | None = None,
) -> MagnetizedState:
    """Build the fixed-capacity state. ``capacity`` > n adds inactive free
    slots — headroom for BCA products / dynamic creation (the reference grows
    its particle list instead, pygcpic.py:1624-1625)."""
    grid = cfg.grid
    n = np.shape(x)[0]
    cap = int(capacity) if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < initial particle count {n}")
    pad = cap - n

    def padded(arr, fill=0.0):
        arr = np.asarray(arr)
        if pad == 0:
            return arr
        shape = (pad,) + arr.shape[1:]
        return np.concatenate([arr, np.full(shape, fill, arr.dtype)])

    x = padded(x)
    v3 = padded(np.broadcast_to(np.asarray(v3), (n, 3)))
    m = padded(np.broadcast_to(np.asarray(m, np.float64), (n,)), fill=1.0)
    charge_state = padded(np.broadcast_to(np.asarray(charge_state, np.float64), (n,)))
    p2c = padded(np.broadcast_to(np.asarray(p2c, np.float64), (n,)))
    species_idx = padded(
        np.broadcast_to(np.asarray(species_idx, np.int32), (n,))
    ).astype(np.int32)
    active0 = np.concatenate(
        [np.ones(n, np.int32), np.zeros(pad, np.int32)]
    )
    yz = None if yz is None else padded(np.asarray(yz))

    p = (jnp.asarray(x) / grid.dx).astype(dtype)
    ne, na = cfg.iead_bins
    s = len(cfg.species_z)
    n = cap
    yz_a = np.zeros((n, 2)) if yz is None else np.asarray(yz)
    v3 = np.asarray(v3)
    state = MagnetizedState(
        p=p,
        y=jnp.asarray(yz_a[:, 0], dtype),
        z=jnp.asarray(yz_a[:, 1], dtype),
        vx=jnp.asarray(v3[:, 0], dtype),
        vy=jnp.asarray(v3[:, 1], dtype),
        vz=jnp.asarray(v3[:, 2], dtype),
        m=jnp.broadcast_to(jnp.asarray(m, dtype), (n,)),
        charge_state=jnp.broadcast_to(jnp.asarray(charge_state, dtype), (n,)),
        p2c=jnp.broadcast_to(jnp.asarray(p2c, dtype), (n,)),
        species_idx=jnp.broadcast_to(jnp.asarray(species_idx, jnp.int32), (n,)),
        t=jnp.zeros((n,), dtype),
        active=jnp.asarray(active0),
        at_wall=jnp.zeros((n,), jnp.int32),
        from_wall=jnp.zeros((n,), jnp.int32),
        mode=jnp.zeros((n,), jnp.int32),
        phi=jnp.zeros((grid.ng,), dtype),
        phi_prev=jnp.zeros((grid.ng,), dtype),
        n0=jnp.asarray(0.0, dtype),
        p_old=jnp.asarray(0.0, dtype),
        added=jnp.asarray(0.0, dtype),
        rng=jax.random.PRNGKey(seed),
        iead=jnp.zeros((s, ne, na), dtype),
        iead_out=jnp.zeros((s, ne, na), dtype),
        step=jnp.asarray(0, jnp.int32),
    )
    if cfg.pusher == "gc":
        # charged active particles integrate as guiding centers; neutrals
        # (and free slots) stay 6D until ionization promotes them
        is_gc = (state.active == 1) & (state.charge_state != 0)
        p_g, yz_g, v_g = _gc_pack(
            state.p, state.yz, state.v, state.charge_state, state.m, cfg
        )
        state = state.replace(
            p=jnp.where(is_gc, p_g, state.p),
            y=jnp.where(is_gc, yz_g[:, 0], state.y),
            z=jnp.where(is_gc, yz_g[:, 1], state.z),
            vx=jnp.where(is_gc, v_g[:, 0], state.vx),
            vy=jnp.where(is_gc, v_g[:, 1], state.vy),
            vz=jnp.where(is_gc, v_g[:, 2], state.vz),
            mode=is_gc.astype(jnp.int32),
        )
    return state


def make_inject(cfg: MagnetizedConfig):
    """Build a jitted injector placing new particles into free slots.

    The fixed-capacity replacement for ``particles += new_particles``
    (pygcpic.py:1624-1625): the i-th valid new particle claims the i-th free
    (inactive) slot. Surplus new particles beyond the free-slot count are
    dropped and counted (the reference grows its list instead; with the
    capped-source policy freeing slots every step the capacity headroom is
    configured by the caller).

    Note the reference does *not* credit the particle ledger for BCA products
    (grid.add_particles is commented out at the injection site,
    pygcpic.py:1616) — neither does this.
    """
    grid = cfg.grid
    dx = grid.dx

    from ..utils import place_rows

    @jax.jit
    def inject(state: MagnetizedState, x, yz, v, m, charge_state, p2c,
               species_idx, t, valid):
        n_new = jnp.sum(valid.astype(jnp.int32))
        inactive = state.active != 1
        yz = jnp.asarray(yz)
        v = jnp.asarray(v)
        new_fields = [jnp.asarray(x) / dx, yz[:, 0], yz[:, 1],
                      v[:, 0], v[:, 1], v[:, 2],
                      jnp.asarray(m), jnp.asarray(charge_state),
                      jnp.asarray(p2c), jnp.asarray(species_idx),
                      jnp.asarray(t)]
        old_fields = [state.p, state.y, state.z, state.vx, state.vy,
                      state.vz, state.m, state.charge_state,
                      state.p2c, state.species_idx, state.t]
        updated, take, n_injected = place_rows(
            inactive, new_fields, n_new, old_fields, valid=valid
        )
        (p_u, y_u, z_u, vx_u, vy_u, vz_u, m_u, cs_u, p2c_u, sp_u,
         t_u) = updated
        new_state = state.replace(
            p=p_u, y=y_u, z=z_u, vx=vx_u, vy=vy_u, vz=vz_u, m=m_u,
            charge_state=cs_u, p2c=p2c_u, species_idx=sp_u, t=t_u,
            active=jnp.where(take, 1, state.active),
            at_wall=jnp.where(take, 0, state.at_wall),
            from_wall=jnp.where(take, 1, state.from_wall),
            # BCA products are neutral 6D particles regardless of the
            # engine pusher (mode 1 requires charge; ionization promotes)
            mode=jnp.where(take, 0, state.mode),
        )
        return new_state, n_injected, n_new - n_injected

    return inject


def boltzmann_n0_update(step, n0_prev, p_old, added, q_new, p_new, *,
                        dt, ve, n_mean):
    """Adaptive Boltzmann reference-density recurrence (pygcpic.py:889-904)
    — shared by this engine and the slab-sharded one so the quirky n0
    update formula lives in exactly one place. The caller supplies the
    (possibly distributed) reductions: ``p_new`` = trapz(exp(phi/Te)) dx,
    ``q_new`` = exp(phi/Te) end-point sum, ``n_mean`` = mean ion density
    (the step-0 seed, 0.9 * n_mean). Returns (n0, p_new)."""
    def first(_):
        return 0.9 * n_mean, p_new

    def later(_):
        r_new = 2.0 * added / dt
        fn = jnp.sqrt(ve * q_new * dt / p_new)
        n0 = n0_prev * (
            (1.0 - fn) * p_old / p_new + fn - fn * fn / 4.0
        ) + r_new * dt / p_new
        return n0, p_new

    return lax.cond(step == 0, first, later, None)


def mirror_gather_position(p, hi):
    """The reference's swapped-intra-cell-weight Dirichlet E gather
    (pygcpic.py:343-347) expressed as a position transform: gathering with
    standard CIC weights at the cell-mirrored position
    ``2 floor(p) + 1 - p`` reproduces it exactly. Shared by both
    magnetized engines; ``hi`` is the clamp bound in the
    caller's coordinate frame (global ``num_cells``, or the extended-slab
    end). The intra-cell fraction is shift-invariant, so applying this in
    a local frame offset by an integer equals the global transform."""
    pc = jnp.clip(p, 0.0, hi)
    return jnp.clip(2.0 * jnp.floor(pc) + 1.0 - pc, 0.0, hi)


def iead_update(iead, species_idx, m, vdx, vdy, vdz, hit, *, bins,
                energy_max, angle_max, deposit_method, allreduce):
    """Wall-impact energy-angle histogram update (pygcpic.py:1239-1262) —
    shared by this engine and the slab-sharded one
    (parallel/domain_magnetized.py) so the reference's binning quirks live
    in exactly one place.

    Out-of-range impacts are excluded, matching np.histogram2d's range
    semantics (pygcpic.py:1259: range=[[0, emax], [0, amax]] discards
    values beyond the range rather than clipping them into edge bins);
    values exactly at the upper edge land in the last bin, as numpy's do.
    Velocities arrive as flat components.

    ``allreduce`` sums the per-shard update before it lands on the
    replicated histogram state (identity on a single device). Returns
    iead + allreduce(update). The histogram runs as a width-0 tent
    deposit over every particle (ops.cic.histogram_add).
    """
    ne, na = bins
    energy_ev = (0.5 * m * (vdx * vdx + vdy * vdy + vdz * vdz)
                 / E_CHARGE)
    vyz = jnp.sqrt(vdy ** 2 + vdz ** 2)
    angle = jnp.arctan2(vyz, jnp.abs(vdx)) * (180.0 / jnp.pi)
    in_range = (
        (energy_ev >= 0.0) & (energy_ev <= energy_max)
        & (angle >= 0.0) & (angle <= angle_max)
    )
    ei = jnp.clip(
        (energy_ev * (ne / energy_max)).astype(jnp.int32), 0, ne - 1
    )
    ai = jnp.clip(
        (angle * (na / angle_max)).astype(jnp.int32), 0, na - 1
    )
    flat = (species_idx * (ne * na) + ei * na + ai)
    contributes = hit & in_range
    # the cast also avoids the x64 float64-into-float32 scatter error
    upd = histogram_add(
        flat,
        jnp.where(contributes, 1.0, 0.0).astype(iead.dtype),
        iead.size,
        method=deposit_method,
    )
    return iead + allreduce(upd.reshape(iead.shape))


def make_step(cfg: MagnetizedConfig):
    grid = cfg.grid
    ng = grid.ng
    dx = grid.dx
    dt = cfg.dt
    cells = float(grid.num_cells)
    def b_vec(dtype):
        # follow the state dtype (a hard f32 cast would truncate B under
        # float64 parity runs; f32 states see the identical f32 values)
        return jnp.asarray(cfg.b, dtype)

    swap_gather = cfg.gather_weights == "reference"

    def gather_pos(p):
        """E-gather position: the reference's Dirichlet interpolation swaps
        the intra-cell weights (pygcpic.py:343-347), which equals gathering
        at the cell-mirrored position (see cfg.gather_weights)."""
        return mirror_gather_position(p, cells) if swap_gather else p
    # eta normalization: reference formula phi/Te/11600 with Te in Kelvin
    # (pygcpic.py:890 — see cfg.eta_in_volts) vs intended phi/(Te/11600).
    te_volts = (cfg.te / EV_TO_K) if cfg.eta_in_volts else (cfg.te * EV_TO_K)
    ve = float(np.sqrt(8.0 / np.pi * K_BOLTZMANN * cfg.te / M_ELECTRON))
    domain_nodes = np.asarray(grid.length) * np.linspace(0.0, 1.0, ng)
    rates = rate_matrix(cfg.species_z, cfg.te) if cfg.ionization else None
    dirichlet_neumann = grid.bc == DIRICHLET_NEUMANN

    def _boltzmann_weight(state, rho, n_dens):
        """Adaptive n0/rho0 update (pygcpic.py:889-904)."""
        eta = jnp.exp(state.phi / te_volts)
        return boltzmann_n0_update(
            state.step, state.n0, state.p_old, state.added,
            q_new=eta[0] + eta[-1], p_new=jnp.trapezoid(eta, dx=dx),
            dt=dt, ve=ve, n_mean=jnp.mean(n_dens),
        )

    def _iead_accumulate(iead, species_idx, m, vdx, vdy, vdz, hit):
        return iead_update(
            iead, species_idx, m, vdx, vdy, vdz, hit,
            bins=cfg.iead_bins, energy_max=cfg.iead_energy_max,
            angle_max=cfg.iead_angle_max,
            deposit_method=cfg.deposit_method, allreduce=_allreduce,
        )

    ax = cfg.axis_name

    def _allreduce(x):
        """Sum partial deposits / counters across particle shards (no-op
        single-device)."""
        return lax.psum(x, ax) if ax else x

    def step(state: MagnetizedState):
        key, k_ion, k_src, k_gyro = jax.random.split(state.rng, 4)
        if ax:
            # per-shard ionization stream (the replicated key would draw
            # identical randoms on every shard); k_src stays replicated —
            # the source sampler's slot offsets make its draws
            # shard-count-invariant instead.
            k_ion = jax.random.fold_in(k_ion, lax.axis_index(ax))
            k_gyro = jax.random.fold_in(k_gyro, lax.axis_index(ax))
        is_active = state.active == 1
        w_rho = jnp.where(
            is_active, state.charge_state * E_CHARGE * state.p2c / dx, 0.0
        )
        w_n = jnp.where(is_active, state.p2c / dx, 0.0)
        rho = _allreduce(deposit(state.p, w_rho, ng, periodic=False,
                                 method=cfg.deposit_method))
        n_dens = _allreduce(deposit(state.p, w_n, ng, periodic=False,
                                    method=cfg.deposit_method))
        n0, p_old = _boltzmann_weight(state, rho, n_dens)
        added = jnp.zeros_like(state.added)  # reset (pygcpic.py:1215,1492)

        if cfg.smooth_rho:
            rho = smooth_bounded(rho)

        # one warm start for BOTH wall conditions
        phi_warm = (
            2.0 * state.phi - state.phi_prev
            if cfg.newton_warm == "extrapolate" else state.phi
        )
        if not dirichlet_neumann:
            # Wall-reference the D-D warm start: the solve's frozen
            # boundary rows keep the walls at exactly 0 pre-shift and the
            # min-shift is uniform, so phi_shifted - phi_shifted[0] IS the
            # previous converged (unshifted) Newton point — the best seed
            # (measured 5.6 -> ~3.4 mean iterations on pic_iead vs pinning
            # the shifted seed's walls alone). The solvers still pin the
            # wall entries as a guard; it is a no-op on this seed. The D-N
            # branch keeps the shifted seed: the reference itself
            # warm-starts that Newton from self.phi (pygcpic.py:1083).
            phi_warm = phi_warm - phi_warm[0]
        if dirichlet_neumann:
            res = solve_boltzmann_dirichlet_neumann(
                n_dens, n0, cfg.te, dx, phi_warm,
                tol=1e-3, maxiter=100,
            )
        else:
            res = solve_boltzmann_dirichlet(
                rho, n0, cfg.te, dx,
                tol=cfg.newton_tol, maxiter=cfg.newton_maxiter,
                phi0=phi_warm,
            )
        phi = res.phi
        e_field = grad_neg_bounded(phi, dx)

        # gather + push (active only; inactive hold their state)
        is_gc = is_active & (state.mode == 1)
        if cfg.pusher == "gc":
            from ..push import gc_push_rk4

            e_p = jnp.where(
                is_active,
                gather(e_field, gather_pos(state.p), periodic=False), 0.0
            )
            x_si = state.p * dx
            v_st = state.v  # stacked views (cold path: GC mixes 6D/GC)
            yz_st = state.yz
            # 6D Boris for neutral / not-yet-promoted particles
            x1_b, yz1_b, v1_b = boris_push_dt(
                x_si, yz_st, v_st, e_p, b_vec(state.vx.dtype),
                state.charge_state, state.m, dt,
            )
            # GC RK4 for mode-1 particles: v packs [v_par, mu, 0]
            pos3 = jnp.stack([x_si, state.y, state.z], axis=-1)
            zeros = jnp.zeros_like(e_p)
            e3 = jnp.stack([e_p, zeros, zeros], axis=-1)
            cs_safe = jnp.where(is_gc, state.charge_state,
                                jnp.ones_like(state.charge_state))
            vpar_safe = jnp.where(state.vx != 0.0, state.vx,
                                  jnp.ones_like(state.vx)) \
                if cfg.gc_eom == "reference" else state.vx
            x1_g3, vpar1, _ = gc_push_rk4(
                pos3, vpar_safe, state.vy, e3, b_vec(state.vx.dtype),
                cs_safe, state.m, dt, eom_form=cfg.gc_eom,
            )
            p1 = jnp.where(
                is_gc, x1_g3[:, 0] / dx,
                jnp.where(is_active, x1_b / dx, state.p),
            )
            y1 = jnp.where(is_gc, x1_g3[:, 1],
                           jnp.where(is_active, yz1_b[:, 0], state.y))
            z1 = jnp.where(is_gc, x1_g3[:, 2],
                           jnp.where(is_active, yz1_b[:, 1], state.z))
            vx1 = jnp.where(is_gc, vpar1,
                            jnp.where(is_active, v1_b[:, 0], state.vx))
            vy1 = jnp.where(is_gc, state.vy,
                            jnp.where(is_active, v1_b[:, 1], state.vy))
            vz1 = jnp.where(is_gc, jnp.zeros_like(vpar1),
                            jnp.where(is_active, v1_b[:, 2], state.vz))
        else:
            e_p = jnp.where(
                is_active,
                gather(e_field, gather_pos(state.p), periodic=False), 0.0
            )
            x_si = state.p * dx
            x1, yz1, v1 = boris_push_dt(
                x_si, state.yz, state.v, e_p, b_vec(state.vx.dtype),
                state.charge_state, state.m, dt,
            )
            p1 = jnp.where(is_active, x1 / dx, state.p)
            y1 = jnp.where(is_active, yz1[:, 0], state.y)
            z1 = jnp.where(is_active, yz1[:, 1], state.z)
            vx1 = jnp.where(is_active, v1[:, 0], state.vx)
            vy1 = jnp.where(is_active, v1[:, 1], state.vy)
            vz1 = jnp.where(is_active, v1[:, 2], state.vz)
        t1 = jnp.where(is_active, state.t + dt, state.t)

        # Dirichlet walls (pygcpic.py:668-689)
        hit = is_active & ((p1 < 0.0) | (p1 > cells))
        active = jnp.where(hit, 0, state.active)
        at_wall = jnp.where(hit, 1, state.at_wall)
        if cfg.pusher == "gc":
            # IEAD / impact diagnostics need the physical 6D velocity:
            # reconstruct with a random gyro-phase (pygcpic.py:553-596)
            yz1_st = jnp.stack([y1, z1], axis=-1)
            v1_st = jnp.stack([vx1, vy1, vz1], axis=-1)
            v6 = _gc_unpack_v(k_gyro, p1, yz1_st, v1_st,
                              state.charge_state, state.m, cfg)
            vdx = jnp.where(is_gc, v6[:, 0], vx1)
            vdy = jnp.where(is_gc, v6[:, 1], vy1)
            vdz = jnp.where(is_gc, v6[:, 2], vz1)
        else:
            vdx, vdy, vdz = vx1, vy1, vz1

        iead = state.iead
        if cfg.iead_energy_max > 0.0:
            iead = _iead_accumulate(
                iead, state.species_idx, state.m, vdx, vdy, vdz, hit)

        # Wall-impact (E, theta) rows for the BCA coupling (fixed-shape form
        # of the reference's per-step lists, pygcpic.py:1516-1527).
        cap = cfg.impact_buffer_size
        if cap > 0:
            from ..utils import pack_rows

            energy_ev = (0.5 * state.m
                         * (vdx * vdx + vdy * vdy + vdz * vdz) / E_CHARGE)
            vyz = jnp.sqrt(vdy ** 2 + vdz ** 2)
            angle = jnp.arctan2(vyz, jnp.abs(vdx)) * (180.0 / jnp.pi)
            side = (p1 > cells).astype(energy_ev.dtype)
            # vx normalized by each particle's thermal speed (the reference's
            # Particle.vth = sqrt(kb T / m), pygcpic.py:100, T = the sampling
            # Ti; cfg.te fallback when no source is configured)
            t_samp = cfg.source.ti if cfg.source is not None else cfg.te
            vth = jnp.sqrt(K_BOLTZMANN * t_samp / state.m)
            rows = jnp.stack(
                [energy_ev, angle, state.species_idx.astype(energy_ev.dtype),
                 side, vdx / vth, jnp.sqrt(y1 * y1 + z1 * z1),
                 state.from_wall.astype(energy_ev.dtype)],
                axis=-1,
            )
            (impacts,), n_impacts, _ = pack_rows(hit, [rows], cap)
        else:
            impacts = jnp.zeros((0, 7), jnp.float32)
            n_impacts = jnp.asarray(0, jnp.int32)

        # Sheath-escape removal of wall-born particles (pygcpic.py:1529-1541):
        # from_wall particles reaching length/2 +/- length/8 are deactivated
        # and recorded in the escape energy-angle histograms.
        iead_out = state.iead_out
        n_escaped = jnp.asarray(0, jnp.int32)
        escapes = jnp.zeros((0, 4), jnp.float32)
        n_escape_rows = jnp.asarray(0, jnp.int32)
        if cfg.bca_escape:
            mid_lo = cells / 2.0 - cells / 8.0
            mid_hi = cells / 2.0 + cells / 8.0
            escaped = (
                (active == 1) & (state.from_wall == 1)
                & (p1 > mid_lo) & (p1 < mid_hi)
            )
            active = jnp.where(escaped, 0, active)
            if cfg.iead_energy_max > 0.0:
                iead_out = _iead_accumulate(
                    iead_out, state.species_idx, state.m, vdx, vdy, vdz,
                    escaped)
            n_escaped = jnp.sum(escaped.astype(jnp.int32))
            if cap > 0:
                # per-event rows for the {source,wall}_out.dat streams
                # (pygcpic.py:1529-1541; energy_ev/angle in scope: cap > 0
                # built them above)
                esc = jnp.stack(
                    [vdx / vth, state.species_idx.astype(energy_ev.dtype),
                     energy_ev, angle], axis=-1)
                (escapes,), n_escape_rows, _ = pack_rows(
                    escaped, [esc], cap)

        # MCC ionization (pygcpic.py:1510-1513)
        n_ionized = jnp.asarray(0, jnp.int32)
        charge_state = state.charge_state
        mode = state.mode
        if cfg.ionization:
            still_active = active == 1
            n_local = jnp.where(
                still_active,
                gather(n_dens, p1, periodic=False),
                0.0,
            )
            charge_state, ionized, added_ion = attempt_ionization(
                k_ion, n_local, charge_state, state.species_idx, state.p2c,
                rates, dx, dt, still_active,
                max_charge_state=cfg.max_charge_state,
            )
            added = added + added_ion
            n_ionized = jnp.sum(ionized.astype(jnp.int32))
            if cfg.pusher == "gc":
                # a neutral that just gained charge becomes magnetized:
                # promote it to GC coordinates (6D -> GC at its current
                # position/velocity)
                promote = ionized & (mode == 0)
                p_g, yz_g, v_g = _gc_pack(
                    p1, jnp.stack([y1, z1], axis=-1),
                    jnp.stack([vx1, vy1, vz1], axis=-1), charge_state,
                    state.m, cfg,
                )
                p1 = jnp.where(promote, p_g, p1)
                y1 = jnp.where(promote, yz_g[:, 0], y1)
                z1 = jnp.where(promote, yz_g[:, 1], z1)
                vx1 = jnp.where(promote, v_g[:, 0], vx1)
                vy1 = jnp.where(promote, v_g[:, 1], vy1)
                vz1 = jnp.where(promote, v_g[:, 2], vz1)
                mode = jnp.where(promote, 1, mode)

        # Re-activation (pygcpic.py:691-720; policies per driver)
        n_react = jnp.asarray(0, jnp.int32)
        m_arr, p2c_arr, sp_arr = state.m, state.p2c, state.species_idx
        fw = state.from_wall
        if cfg.reactivate != "none":
            src = cfg.source
            # 'reference': slots inactive at step START (pre-push) — a slot
            # lost during this step's push waits one step, reproducing the
            # reference's one-weighting limbo (see cfg.react_timing)
            inactive = ((state.active != 1)
                        if cfg.react_timing == "reference"
                        else (active != 1))
            from ..utils import compact_rows

            k_batch = state.p.shape[0]
            n_draw = cfg.react_batch or k_batch
            rank = compact_rows(inactive)
            if ax and (cfg.react_batch
                       or cfg.reactivate in ("capped-source", "flux")):
                # Global-rank allocation of the cap across shards: shard r's
                # inactive slots rank after every inactive slot of shards
                # 0..r-1 (exclusive prefix of the per-shard counts over the
                # axis). shard_map splits the particle arrays into contiguous
                # blocks, so this global order IS the single-device slot
                # order — the globally-capped take set matches the
                # single-device run exactly (equivalence-tested).
                n_inact = jnp.sum(inactive.astype(jnp.int32))
                counts = lax.all_gather(n_inact, ax)
                before = jnp.sum(jnp.where(
                    jnp.arange(counts.shape[0]) < lax.axis_index(ax),
                    counts, 0,
                ))
                rank = rank + before
            src_kw = {"components": True}
            src_sampler = cfg.source_sampler
            if src_sampler == "auto":
                # hash: the only shard-invariant full-capacity draw
                # (required under dp at react_batch=0; rank-keyed capped
                # batches are shard-invariant for every sampler)
                src_sampler = ("hash" if ax and not cfg.react_batch
                               else "threefry")
            if src_sampler == "hash":
                sample_source = sources.sample_source_6d_hash
                sample_flux = sources.sample_flux_6d_hash
                if ax and not cfg.react_batch:
                    # global slot ids: shard r draws the same values the
                    # single-device run draws for its slots — the sharded
                    # re-activation batch is shard-count-invariant.
                    # (react_batch draws are keyed on the GLOBAL rank via
                    # positions 0..B-1 of the replicated table — no offset.)
                    src_kw["slot_offset"] = lax.axis_index(ax) * k_batch
            else:
                sample_source = sources.sample_source_6d
                sample_flux = sources.sample_flux_6d
            if cfg.reactivate == "source":
                batch = sample_source(
                    k_src, n_draw, grid, src.ti, src.mass, vx=src.vx,
                    **src_kw,
                )
                take = inactive
            elif cfg.reactivate == "capped-source":
                # pic_bca_aps: refill only while the active ionized source-
                # species population is below source_n; the rest stay free
                # slots (reactivate-or-delete, pygcpic.py:1543-1549). Under
                # dp the cap counts the GLOBAL population.
                batch = sample_source(
                    k_src, n_draw, grid, src.ti, src.mass, vx=src.vx,
                    **src_kw,
                )
                n_src_active = _allreduce(jnp.sum(
                    ((active == 1)
                     & (state.species_idx == src.species_idx)
                     & (charge_state > 0)).astype(jnp.int32)
                ))
                deficit = jnp.maximum(cfg.source_n - n_src_active, 0)
                if cfg.react_timing == "reference" and not cfg.react_batch:
                    # The reference re-evaluates the count at EACH pending
                    # slot's turn in the particle loop (pygcpic.py:
                    # 1543-1549), so a countable particle at a HIGHER slot
                    # index lost THIS step still counts as active when a
                    # lower pending slot is considered: pending slot j is
                    # admitted iff (admissions before j) <
                    # allow_j = deficit - (countable same-step losses at
                    # global indices > j). allow is non-decreasing along
                    # slots, which gives the admitted count the min-plus
                    # closed form A_before_j = rank_j + min(0,
                    # exclusive-cummin(allow - rank - 1)); with zero
                    # same-step losses this reduces exactly to the
                    # rank < deficit prefix. Applies to the react_batch=0
                    # reference-parity path only: the rank-keyed
                    # react_batch>0 draw is already documented as not
                    # bit-compatible with the reference stream, and the
                    # slab engine shares the
                    # deviation (migration reorders slots, so reference
                    # slot order is unrecoverable there anyway).
                    lost_now = ((state.active == 1) & (active != 1)
                                & (state.species_idx == src.species_idx)
                                & (charge_state > 0)).astype(jnp.int32)
                    n_lost_loc = jnp.sum(lost_now)
                    suffix = n_lost_loc - jnp.cumsum(lost_now)
                    if ax:
                        lcounts = lax.all_gather(n_lost_loc, ax)
                        shard = lax.axis_index(ax)
                        suffix = suffix + jnp.sum(jnp.where(
                            jnp.arange(lcounts.shape[0]) > shard,
                            lcounts, 0))
                    allow = jnp.maximum(deficit - suffix, 0)
                    big = jnp.asarray(np.iinfo(np.int32).max, jnp.int32)
                    tt = jnp.where(inactive, allow - (rank + 1), big)
                    m_incl = lax.associative_scan(jnp.minimum, tt)
                    m_excl = jnp.concatenate([big[None], m_incl[:-1]])
                    if ax:
                        gmins = lax.all_gather(jnp.min(tt), ax)
                        lower = jnp.min(jnp.where(
                            jnp.arange(gmins.shape[0]) < shard,
                            gmins, big))
                        m_excl = jnp.minimum(m_excl, lower)
                    a_before = rank + jnp.minimum(0, m_excl)
                    take = inactive & (a_before < allow)
                else:
                    take = inactive & (rank < deficit)
            else:  # 'flux'
                batch = sample_flux(
                    k_src, n_draw, grid, src.ti, src.mass,
                    vx=src.vx, gamma=cfg.flux_gamma, vx_pert=cfg.flux_vx_pert,
                    **src_kw,
                )
                batch["vx"] = -jnp.abs(batch["vx"])  # pygcpic.py:2059
                take = inactive & (rank < cfg.flux_limit)
            bx = batch["x"] / dx
            bvx, bvy, bvz = batch["vx"], batch["vy"], batch["vz"]
            by = jnp.zeros((n_draw,), bvx.dtype)  # both samplers: yz = 0
            bz = by
            react_mode = 0
            if cfg.pusher == "gc" and src.charge_state != 0:
                # charged re-activated particles enter in GC coordinates
                cs_b = jnp.full((n_draw,), src.charge_state, bvx.dtype)
                m_b = jnp.full((n_draw,), src.mass, bvx.dtype)
                bx, byz_g, bv_g = _gc_pack(
                    bx, jnp.stack([by, bz], axis=-1),
                    jnp.stack([bvx, bvy, bvz], axis=-1), cs_b, m_b, cfg,
                )
                by, bz = byz_g[:, 0], byz_g[:, 1]
                bvx, bvy, bvz = bv_g[:, 0], bv_g[:, 1], bv_g[:, 2]
                react_mode = 1
            if cfg.react_batch:
                # slot i's draw sits at its re-activation rank in the
                # (react_batch,)-sized table; cap the take set at the table
                # size — surplus inactive slots wait for the next step
                take = take & (rank < cfg.react_batch)
                idx = jnp.clip(rank, 0, cfg.react_batch - 1)
                bx, by, bz, bvx, bvy, bvz = (
                    jnp.take(b_, idx) for b_ in (bx, by, bz, bvx, bvy, bvz)
                )
            p1 = jnp.where(take, bx, p1)
            y1 = jnp.where(take, by, y1)
            z1 = jnp.where(take, bz, z1)
            vx1 = jnp.where(take, bvx, vx1)
            vy1 = jnp.where(take, bvy, vy1)
            vz1 = jnp.where(take, bvz, vz1)
            mode = jnp.where(take, react_mode, mode)
            m_arr = jnp.where(take, src.mass, m_arr)
            charge_state = jnp.where(take, src.charge_state, charge_state)
            p2c_arr = jnp.where(take, src.p2c, p2c_arr)
            sp_arr = jnp.where(take, src.species_idx, sp_arr)
            t1 = jnp.where(take, state.step.astype(t1.dtype) * dt, t1)
            active = jnp.where(take, 1, active)
            at_wall = jnp.where(take, 0, at_wall)
            fw = jnp.where(take, 0, fw)
            n_react = jnp.sum(take.astype(jnp.int32))
            added = added + (2.0 * src.p2c) * jnp.sum(take.astype(added.dtype))

        # global ledgers/counters under dp (the n0 particle-balance update
        # next step needs the GLOBAL added-particle rate, pygcpic.py:889-904)
        added = _allreduce(added)
        metrics = StepMetrics(
            n0=n0,
            phi_max=jnp.max(phi),
            newton_iters=res.iterations,
            newton_residual=res.residual,
            n_active=_allreduce(jnp.sum((active == 1).astype(jnp.int32))),
            n_hit_wall=_allreduce(jnp.sum(hit.astype(jnp.int32))),
            n_ionized=_allreduce(n_ionized),
            n_reactivated=_allreduce(n_react),
            added=added,
            rho=rho,
            phi=phi,
            impacts=impacts,
            n_impacts=n_impacts,
            n_escaped=_allreduce(n_escaped),
            escapes=escapes,
            n_escape_rows=n_escape_rows,
        )
        new_state = state.replace(
            p=p1, y=y1, z=z1, vx=vx1, vy=vy1, vz=vz1, m=m_arr,
            charge_state=charge_state,
            p2c=p2c_arr, species_idx=sp_arr, t=t1, active=active,
            at_wall=at_wall, from_wall=fw, mode=mode, phi=phi,
            phi_prev=state.phi,
            n0=n0, p_old=p_old, added=added, rng=key, iead=iead,
            iead_out=iead_out, step=state.step + 1,
        )
        return new_state, metrics

    return step
