"""Spatial domain decomposition: slab-sharded grid + particle migration.

The capability BASELINE.json configs[4] adds over the reference (which is
single-process, SURVEY.md §2.6): the 1D domain is split into one slab of
``cells_per_shard`` cells per device;

* each device **deposits only onto its own slab** plus a halo of
  ``halo_width`` nodes per side — halo nodes ride ``ppermute`` to the
  neighbour instead of an O(ng) psum, so grid memory and reduction cost per
  device stay O(ng/D) (the answer to the reference's tiny-but-growable grids,
  pypic.py:851 ng=200 .. pygcpic.py:1974 ng=800, at ng >> 1e5);
* fields are likewise slab-sharded; engines whose field advance is local
  (the Ampere-law update ``E1 = E0 + dt/eps0 (<jh> - smooth(jh))``,
  pypic.py:283, PIC_L_DD.py:516) never materialize the global grid — the
  mean is a psum and the binomial smoother needs a 1-node halo
  (see ``pypic_tpu.parallel.domain_implicit``);
* particles live on the device owning their slab; after the push each
  particle whose destination slab changed is packed into a fixed-capacity
  neighbour bucket and ``ppermute``-d around the ring, **repeating until no
  particle is misrouted** (multi-hop routing — a fast tail particle crossing
  several narrow slabs in one dt is a physics event, not an error). Only
  bucket-capacity overflow is dropped, and it is *counted*, never silent
  (SURVEY.md §7 hard part 5); size ``migrate_cap`` accordingly.

The explicit periodic cycle (PIC_L.py:762-768) is the carrier engine here;
``domain_implicit`` composes the same machinery with the flagship CN-Picard
engine (pypic.py:216-300) and ``domain_sheath`` with the bounded
absorbing-wall engine (PIC_L_DD.py:316-644).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..utils.pytree import PyTreeNode
from ..constants import EPSILON_0
from ..grid import GridSpec
from ..ops import deposit, gather, grad_periodic, solve_periodic_neutralized
from ..push import leapfrog_push
from ..utils import pack_rows, place_rows

shard_map = jax.shard_map


@dataclasses.dataclass(frozen=True)
class DomainConfig:
    grid: GridSpec  # global grid; ng must divide by num_shards
    dt: float
    p2c: float
    num_shards: int
    migrate_cap: int = 4096  # per-direction bucket size per migration round
    # Deposit halo width in nodes: deposits cover [lo-halo, lo+c+halo] with
    # halo contributions folded to their owners, so particles may excurse up
    # to ``halo`` cells off their slab between migrations. Only the
    # migration-amortized superstep (make_superstep) needs halo > 0; the
    # per-step path migrates every step, so its particles never excurse and
    # a wider halo just wastes deposit work.
    halo: int = 0
    # 'replicated' all_gathers the (small) grid and solves the FFT Poisson on
    # every shard — right for the reference's ng of 40-800; 'distributed'
    # keeps the solve slab-local via tridiagonal substructuring (O(ng/D)
    # work + O(D) interface comm, parallel.distributed_poisson) — the
    # large-Ng scaling path (SURVEY.md §5).
    field_solve: str = "replicated"
    axis_name: str = "slabs"
    deposit_method: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "dt", float(self.dt))
        object.__setattr__(self, "p2c", float(self.p2c))
        if self.grid.ng % self.num_shards:
            raise ValueError(
                f"ng={self.grid.ng} not divisible by {self.num_shards} shards"
            )
        if self.halo < 0 or self.halo + 1 > self.cells_per_shard:
            raise ValueError(
                f"halo={self.halo} must be in [0, cells_per_shard-1] "
                f"(cells_per_shard={self.cells_per_shard})"
            )

    @property
    def cells_per_shard(self) -> int:
        return self.grid.ng // self.num_shards


def ring_perms(d_tot: int, periodic: bool = True):
    """(perm_right, perm_left) source->dest pairs for a 1D shard ring/chain."""
    if periodic:
        perm_r = [(i, (i + 1) % d_tot) for i in range(d_tot)]
        perm_l = [(i, (i - 1) % d_tot) for i in range(d_tot)]
    else:
        perm_r = [(i, i + 1) for i in range(d_tot - 1)]
        perm_l = [(i, i - 1) for i in range(1, d_tot)]
    return perm_r, perm_l


# ---------------------------------------------------------------------------
# Halo exchange for slab-sharded node fields
# ---------------------------------------------------------------------------


def halo_extend(own, hw: int, ax: str, perm_r, perm_l):
    """Extend a (c,) owned-slab array with hw halo nodes on the left and
    hw + 1 on the right, fetched from the ring neighbours.

    Result covers global nodes [lo - hw, lo + c + hw] (c + 2*hw + 1 nodes).
    Devices without a neighbour (chain perms) get zero halos.
    """
    c = own.shape[0]
    if hw + 1 > c:
        raise ValueError(f"halo width {hw} too large for {c}-cell slabs")
    parts = []
    if hw > 0:
        parts.append(lax.ppermute(own[-hw:], ax, perm_r))  # from left nbr
    parts.append(own)
    parts.append(lax.ppermute(own[: hw + 1], ax, perm_l))  # from right nbr
    return jnp.concatenate(parts)


def halo_fold(ext, c: int, hw: int, ax: str, perm_r, perm_l):
    """Fold an extended deposit (c + 2*hw + 1 nodes covering
    [lo - hw, lo + c + hw]) back onto the (c,) owned slab, sending halo
    contributions to their owning neighbours."""
    own = ext[hw : hw + c]
    # My right-halo nodes [lo + c, lo + c + hw] belong to the right
    # neighbour's own[:hw + 1]; I receive the left neighbour's equivalent.
    from_left = lax.ppermute(ext[hw + c :], ax, perm_r)
    own = own.at[: hw + 1].add(from_left)
    if hw > 0:
        # My left-halo nodes [lo - hw, lo) belong to the left neighbour's
        # own[c - hw:]; I receive the right neighbour's equivalent.
        from_right = lax.ppermute(ext[:hw], ax, perm_l)
        own = own.at[c - hw :].add(from_right)
    return own


# ---------------------------------------------------------------------------
# Multi-hop particle migration
# ---------------------------------------------------------------------------


def migrate(
    fields: Sequence[jax.Array],
    alive: jax.Array,
    d: jax.Array,
    *,
    ng: int,
    cells_per_shard: int,
    num_shards: int,
    cap: int,
    ax: str,
    periodic: bool = True,
    count_axes=None,
):
    """Route alive particles to the shard owning their slab.

    ``fields[0]`` must be the position in *global* grid coordinates (already
    wrapped for periodic domains). Particles move one slab per round along
    the shortest ring path (or toward their destination on a bounded chain),
    looping until every particle is on its owner — so a particle legitimately
    crossing several slabs in one dt survives. Bucket-capacity overflow and
    full-destination overflow are dropped *with a count* (never silent).

    ``count_axes``: axes the remaining-work count reduces over (default
    ``ax``). On a composed mesh (slabs x replicas) this MUST include every
    mesh axis — the while_loop's ppermutes compile as whole-mesh
    collectives, so replicas disagreeing on the ROUND COUNT deadlock the
    collective rendezvous (replicas with no work run no-op rounds instead).

    Returns (fields, alive, n_migrated, n_dropped) with counts global over
    ``ax`` (callers psum any replica axis themselves).
    """
    c = cells_per_shard
    d_tot = num_shards
    if d_tot == 1:
        # dest_of is identically this shard: migration is a no-op by
        # construction. Skip its full-array routing scans and return exact
        # zero counts.
        zero = jnp.asarray(0, jnp.int32)
        return list(fields), alive, zero, zero
    perm_r, perm_l = ring_perms(d_tot, periodic)
    if count_axes is None:
        count_axes = ax

    def dest_of(p):
        cell = jnp.clip(jnp.floor(p).astype(jnp.int32), 0, ng - 1)
        return cell // c

    def misrouted(p, alive):
        return alive & (dest_of(p) != d)

    def n_remaining(p, alive):
        return lax.psum(jnp.sum(misrouted(p, alive).astype(jnp.int32)),
                        count_axes)

    def send(mask, fields, perm):
        """Pack up to cap masked rows per field and ppermute them."""
        bufs, n_valid, overflow = pack_rows(mask, fields, cap)
        recv = [lax.ppermute(b, ax, perm) for b in bufs]
        recv_n = lax.ppermute(n_valid, ax, perm)
        return recv, recv_n, overflow

    def place(fields, alive, recv, recv_n):
        new_fields, take, placed = place_rows(~alive, recv, recv_n, fields)
        return new_fields, alive | take, recv_n - placed

    def body(carry):
        fields, alive, _, n_mig, n_drop, k = carry
        p = fields[0]
        if periodic:
            diff = jnp.mod(dest_of(p) - d, d_tot)
            go_r = alive & (diff >= 1) & (diff <= d_tot // 2)
            go_l = alive & (diff > d_tot // 2)
        else:
            dest = dest_of(p)
            go_r = alive & (dest > d)
            go_l = alive & (dest < d)

        recv_r, n_r, ovf_r = send(go_r, fields, perm_r)
        recv_l, n_l, ovf_l = send(go_l, fields, perm_l)
        # Senders leave this shard; overflowed senders are the dropped ones.
        alive = alive & ~(go_r | go_l)
        fields, alive, short_r = place(fields, alive, recv_r, n_r)
        fields, alive, short_l = place(fields, alive, recv_l, n_l)

        n_mig = (n_mig + lax.psum(n_r + n_l, ax)).astype(jnp.int32)
        n_drop = (
            n_drop + lax.psum(ovf_r + ovf_l + short_r + short_l, ax)
        ).astype(jnp.int32)
        return (
            tuple(fields), alive,
            n_remaining(fields[0], alive), n_mig, n_drop, k + 1,
        )

    def cond(carry):
        _, _, n_rem, _, _, k = carry
        # Dropped particles leave `alive`, so n_rem strictly decreases;
        # the k bound is a pure safety net.
        return (n_rem > 0) & (k < d_tot)

    zero = jnp.asarray(0, jnp.int32)
    carry = (
        tuple(fields), alive,
        n_remaining(fields[0], alive), zero, zero, zero,
    )
    fields, alive, _, n_mig, n_drop, _ = lax.while_loop(cond, body, carry)
    return list(fields), alive, n_mig, n_drop


# ---------------------------------------------------------------------------
# Explicit periodic carrier engine (PIC_L.py:762-768)
# ---------------------------------------------------------------------------


class DomainState(PyTreeNode):
    """Per-shard fixed-capacity particles; global grid-coordinate positions."""

    p: jax.Array  # (num_shards*capacity,) global grid coords (sharded dim 0)
    v: jax.Array  # same sharding
    alive: jax.Array  # bool
    q: jax.Array  # () charge (single species)
    m: jax.Array  # ()
    step: jax.Array  # () int32


class StepMetrics(NamedTuple):
    field_energy: jax.Array
    kinetic_energy: jax.Array
    n_alive: jax.Array
    n_migrated: jax.Array  # particles exchanged this step (global)
    n_dropped: jax.Array  # migration bucket/slot overflow (global)
    # superstep micro-steps: alive particles outside the deposit halo
    # (clamped for grid work — detected, never silent); 0 on the per-step path
    n_halo_clamped: jax.Array = 0


def distribute_by_slab(arrays, x, cfg, capacity_factor: float = 1.5):
    """Lay out host per-particle arrays as (num_shards, capacity) blocks by
    slab ownership of position x [m]. Returns (blocks, alive, capacity)."""
    grid = cfg.grid
    p = np.asarray(x) / grid.dx
    cell = np.floor(p).astype(np.int64) % grid.ng
    owner = np.clip(cell // cfg.cells_per_shard, 0, cfg.num_shards - 1)
    counts = np.bincount(owner, minlength=cfg.num_shards)
    capacity = int(np.ceil(counts.max() * capacity_factor))
    n_s = cfg.num_shards
    outs = []
    for a in arrays:
        a = np.asarray(a)
        out = np.zeros((n_s, capacity) + a.shape[1:], a.dtype)
        outs.append(out)
    alive = np.zeros((n_s, capacity), bool)
    for dd in range(n_s):
        sel = owner == dd
        k = int(sel.sum())
        if k > capacity:
            raise ValueError("capacity_factor too small")
        for a, out in zip(arrays, outs):
            out[dd, :k] = np.asarray(a)[sel]
        alive[dd, :k] = True
    return outs, alive, capacity


def init_state(x, v, q, m, cfg: DomainConfig, capacity_factor: float = 1.5):
    """Distribute host arrays onto shards by slab ownership.

    Returns a host-side DomainState (leading dim num_shards*capacity) laid
    out so that a reshape to (num_shards, capacity) puts each particle on its
    owning shard; feed through ``shard_state`` before stepping.
    """
    p = np.asarray(x) / cfg.grid.dx
    (p_out, v_out), alive, _ = distribute_by_slab(
        [p.astype(np.float32), np.asarray(v, np.float32)], x, cfg,
        capacity_factor,
    )
    return DomainState(
        p=jnp.asarray(p_out.reshape(-1)),
        v=jnp.asarray(v_out.reshape(-1)),
        alive=jnp.asarray(alive.reshape(-1)),
        q=jnp.asarray(q, jnp.float32),
        m=jnp.asarray(m, jnp.float32),
        step=jnp.asarray(0, jnp.int32),
    )


def shard_state(state, mesh: Mesh, cfg):
    spec = state_spec(state, cfg.axis_name)
    return jax.tree.map(
        lambda leaf, s: jax.device_put(leaf, jax.sharding.NamedSharding(mesh, s)),
        state, spec,
    )


def state_spec(state, ax: str):
    """PartitionSpec pytree: per-particle/per-node leaves sharded, scalars
    replicated."""
    return jax.tree.map(
        lambda leaf: P(ax) if jnp.ndim(leaf) >= 1 else P(), state
    )


def make_step(cfg: DomainConfig, mesh: Mesh):
    """Build the shard_mapped domain-decomposed explicit step (migrates
    every step; scalar metrics)."""
    return _make_stepper(cfg, mesh, None)


def make_superstep(cfg: DomainConfig, mesh: Mesh, migrate_every: int):
    """Migration-amortized explicit superstep: run ``migrate_every``
    deposit-solve-push micro-steps back-to-back and migrate ONCE, on the
    last. The domain-implicit analog is
    ``domain_implicit.make_superstep`` — same contract (metrics leaves gain
    a leading (migrate_every,) axis; ``n_migrated``/``n_dropped`` land in
    the last slot; ``state.step`` advances by ``migrate_every``).

    Positions ride RAW (unwrapped) global coordinates between micro-steps
    so slab locality survives the periodic seam; deposits cover
    [lo - halo, lo + c + halo] with halo contributions folded to their
    owners, so any excursion within ``cfg.halo`` cells is exact.
    Outrunners are clamped for grid work and counted per micro-step in
    ``n_halo_clamped``. Size ``halo >= migrate_every * v_max * dt / dx``.

    The replicated field solve gathers E from the global grid (wrap applied
    for the gather only), so it is exact for ANY excursion; the distributed
    solve gathers from the halo-extended slab field (clamped like the
    deposit)."""
    k_mig = int(migrate_every)
    if k_mig < 1:
        raise ValueError(f"migrate_every must be >= 1, got {k_mig}")
    return _make_stepper(cfg, mesh, k_mig)


def _make_stepper(cfg: DomainConfig, mesh: Mesh, k_mig):
    """Shared builder: ``k_mig=None`` -> per-step migration with scalar
    metrics; ``k_mig=k`` -> the k-micro-step superstep (stacked metrics).
    One micro-step implementation serves both, so superstep(k=1) is
    bit-identical to the per-step path."""
    grid = cfg.grid
    ng = grid.ng
    dx = grid.dx
    dt = cfg.dt
    dt_dx = dt / dx
    c = cfg.cells_per_shard
    d_tot = cfg.num_shards
    hw = cfg.halo
    ext_n = c + 2 * hw + 1
    ax = cfg.axis_name
    perm_r, perm_l = ring_perms(d_tot)
    if cfg.field_solve == "distributed":
        from .distributed_poisson import make_distributed_periodic_poisson

        dist_solve = make_distributed_periodic_poisson(ng, dx, d_tot, ax)
    elif cfg.field_solve != "replicated":
        raise ValueError(f"unknown field_solve {cfg.field_solve!r}")

    # Only scanned micro-steps (k >= 2) can see off-owner positions: the
    # per-step and k=1 paths start every micro-step post-migration, so
    # their clamp count is provably zero and their gather coordinate is
    # already wrapped — skip the compare/reduce/psum and the mod there
    # (a returned metric would force XLA to emit them at 1e8 every step).
    excursions = k_mig is not None and k_mig > 1
    def local_step(state: DomainState):
        d = lax.axis_index(ax)
        alive = state.alive
        qm = state.q / state.m
        w = jnp.where(alive, state.q * (cfg.p2c / dx), 0.0)
        lo = d.astype(state.p.dtype) * c
        n_alive0 = lax.psum(jnp.sum(alive.astype(jnp.int32)), ax)
        zero_i = jnp.asarray(0, jnp.int32)

        def micro(carry, _):
            # p in RAW global coords: on-owner at the first micro-step, up
            # to ``halo`` cells off (unwrapped — slab locality survives the
            # periodic seam) on later ones. Deposit onto the halo-extended
            # slab [lo-hw, lo+c+hw], fold halo contributions to owners (the
            # global wrap for the seam shards is the ring ppermute itself);
            # off-halo outrunners are clamped for grid work and counted.
            p, v = carry
            p_loc = p - lo
            n_clamped = (
                lax.psum(jnp.sum(
                    (alive & ((p_loc < -hw) | (p_loc > c + hw))
                     ).astype(jnp.int32)), ax)
                if excursions else zero_i
            )
            p_cl = jnp.clip(p_loc, -hw, c + hw)
            rho_ext = deposit(
                jnp.where(alive, p_cl, 0.0) + hw, w, ext_n,
                periodic=False, method=cfg.deposit_method,
            )
            rho_own = halo_fold(rho_ext, c, hw, ax, perm_r, perm_l)

            if cfg.field_solve == "distributed":
                # slab-local Poisson (substructuring); E by a 1-node-halo
                # centered difference (E is gauge-invariant, no max shift);
                # gather from the hw-extended slab field in local coords
                phi_own = dist_solve(rho_own)
                phi_ext = halo_extend(phi_own, 1, ax, perm_r, perm_l)
                e_own = -(phi_ext[2:c + 2] - phi_ext[:c]) / (2.0 * dx)
                e_ext = halo_extend(e_own, hw, ax, perm_r, perm_l)
                e_p = jnp.where(
                    alive, gather(e_ext, p_cl + hw, periodic=False), 0.0
                )
                e_energy = lax.psum(jnp.sum(e_own * e_own), ax)
                p1, v1 = leapfrog_push(p, v, e_p, qm, dt, dt_dx)
            else:
                # replicated global solve (ng small; all_gather is O(ng));
                # the global gather is exact for ANY excursion (wrap applied
                # for the gather coordinate only)
                rho_full = lax.all_gather(rho_own, ax, tiled=True)
                phi = solve_periodic_neutralized(rho_full, dx)
                phi = phi - jnp.max(phi)
                e_full = -grad_periodic(phi, dx)
                e_energy = jnp.sum(e_full * e_full)
                gcoord = jnp.mod(p, ng) if excursions else p
                e_p = jnp.where(
                    alive, gather(e_full, gcoord, periodic=True), 0.0
                )
                p1, v1 = leapfrog_push(p, v, e_p, qm, dt, dt_dx)
            p1 = jnp.where(alive, p1, 0.0)
            v1 = jnp.where(alive, v1, 0.0)
            met = StepMetrics(
                field_energy=0.5 * EPSILON_0 * dx * e_energy,
                kinetic_energy=lax.psum(
                    0.5 * cfg.p2c * state.m
                    * jnp.sum(jnp.where(alive, v * v, 0.0)),
                    ax,
                ),
                n_alive=n_alive0,
                n_migrated=zero_i,
                n_dropped=zero_i,
                n_halo_clamped=n_clamped,
            )
            return (p1, v1), met

        if k_mig is None or k_mig == 1:
            # scan-free (a length-1 scan changes XLA fusion boundaries and
            # costs bit-exactness via FMA contraction differences)
            (p1, v1), met = micro((state.p, state.v), None)
            ms = None if k_mig is None else jax.tree.map(
                lambda a: jnp.asarray(a)[None], met
            )
        else:
            (p1, v1), ms = lax.scan(
                micro, (state.p, state.v), None, length=k_mig
            )
        p1 = jnp.where(alive, jnp.mod(p1, ng), 0.0)

        # --- multi-hop migration to owner slabs
        (p2, v2), alive1, n_migrated, n_dropped = migrate(
            [p1, v1], alive, d,
            ng=ng, cells_per_shard=c, num_shards=d_tot,
            cap=cfg.migrate_cap, ax=ax,
        )
        n_alive1 = lax.psum(jnp.sum(alive1.astype(jnp.int32)), ax)
        if k_mig is None:
            metrics = met._replace(
                n_migrated=n_migrated, n_dropped=n_dropped, n_alive=n_alive1
            )
        else:
            metrics = ms._replace(
                n_migrated=ms.n_migrated.at[-1].set(n_migrated),
                n_dropped=ms.n_dropped.at[-1].set(n_dropped),
                n_alive=ms.n_alive.at[-1].set(n_alive1),
            )
        new_state = state.replace(
            p=p2, v=v2, alive=alive1,
            step=state.step + (1 if k_mig is None else k_mig),
        )
        return new_state, metrics

    spec = DomainState(
        p=P(ax), v=P(ax), alive=P(ax), q=P(), m=P(), step=P(),
    )
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
