#!/usr/bin/env python
"""Benchmarks: particle pushes per second per GPU against the BASELINE.md configs.

Default prints ONE JSON line — the headline config (the flagship implicit
engine at the reference's canonical Landau-damping workload, run_pypic.py:
pypic.main preset, pypic.py:846-855, scaled to 1e8 particles) with every
other matrix row it could measure inside the wall-clock budget folded in
under "rows", plus the chunked 1e4-step energy-drift protocol:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
     "platform": ..., "device_kind": ..., "device_count": N,
     "gpu": "<nvidia-smi name, power limit>", "rows": {"sheath": {...}},
     "drift_per_1e4": N, "drift_steps": N, "skipped": [...], "failed": [...]}
vs_baseline is measured pushes/sec divided by the 1e9 north-star target
(BASELINE.json; the reference publishes no numbers and cannot run in this
image — it requires numba). Every row names the device it ran on.

Every row runs in its OWN subprocess, one after another, so exactly one JAX
process holds the GPU at any time (a JAX process reserves most of the card's
memory when it starts) and one row's failure cannot take the rest. The
parent process never initializes a JAX backend; a SIGTERM/SIGINT mid-matrix
still prints the partial artifact.

The measurement needs an NVIDIA GPU: without one bench.py exits non-zero.
``--cpu`` runs the rows on the CPU as a wiring smoke test, and its rows say
``[cpu]`` in their unit.

The default headline is the CONSERVING configuration (fixed 4 Picard
sweeps + extrapolated init + Anderson mixing, PERF.md drift table).
``--throughput`` switches to the tol-1e-9 configuration.

``--all`` runs the full BASELINE.md "configs to report" matrix in one
process, one JSON line per config:
  1. two_stream   — explicit engine, ~1e4 particles (configs[0])
  2. landau       — implicit engine, 1e5 particles (configs[1])
  3. sheath       — bounded 2-species sheath, 1e6 (configs[2], PIC_L_DD)
  4. magnetized   — Boris + Newton-Boltzmann + IEAD, 1e6 (configs[3])
  5. domain       — domain-decomposed implicit at 1e8 over the device mesh
                    (configs[4])
  6. headline     — implicit at 1e8 (north-star row)

Timings fetch a scalar to the host after each timed region, and warmup uses
the same static step count as the timed run so compilation stays out of the
measured region.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

NORTH_STAR = 1e9
_PICARD_INIT = "field"
_FINALIZE = "converged"
_ACCEL = "none"
_FINALIZE_FIELD = "last"
_CPU_SMOKE = False


def _device_info():
    """Where the measurement ran: JAX's view of the device, plus the GPU's
    name and power limit from nvidia-smi (a card set below its maximum
    power runs slower under load, so every number carries its limit)."""
    import jax

    from pypic_tpu.platform import gpu_name_and_power_limit

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices()),
            "gpu": gpu_name_and_power_limit()}


def _require_gpu():
    """Refuse to measure anywhere but on an NVIDIA GPU (``--cpu`` aside)."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"bench: no GPU found (JAX platform {platform!r}); "
                         "pass --cpu for a wiring smoke test")


def _emit(name, n, steps, elapsed, extra=""):
    """Print the row's stderr summary + the JSON row the driver parses
    (one line per row; the default mode's parent process collects these
    from per-row subprocesses into the combined line)."""
    pushes = n * steps / elapsed
    print(f"bench[{name}]: {elapsed / steps * 1e3:.2f} ms/step {extra}",
          file=sys.stderr)
    row = {
        "metric": f"{name}_pushes_per_sec_per_chip"
        if name != "headline" else "particle_pushes_per_sec_per_chip",
        "value": pushes,
        "unit": "pushes/s [cpu]" if _CPU_SMOKE else "pushes/s",
        "vs_baseline": pushes / NORTH_STAR,
    }
    row.update(_device_info())
    print(json.dumps(row))
    return pushes


def _time(run_fn, warm=True, reps=2):
    """Run once to compile+warm, then return the BEST of ``reps`` timed
    runs (min-of-2 filters host-side jitter on the sub-second rows)."""
    t0 = time.perf_counter()
    run_fn()
    print(f"  compile+first run {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        run_fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _drift_loop(step, state, drift_steps, spc=1, budget_s=None):
    """North-star drift protocol: total-energy change over ``drift_steps``
    SIM steps in chunked dispatches of ~1000 steps (one metrics fetch per
    chunk). ``spc`` = sim steps per step() call (supersteps): chunks count
    calls so each dispatch still covers ~1000 sim steps, and the metrics'
    (chunk, spc) stack flattens to per-micro-step order.

    ``budget_s`` bounds the wall clock: the loop stops early (after at
    least one chunk) when the next chunk's estimated cost would overrun.
    Returns ``(relative_drift, sim_steps_covered)`` — drift at these
    settings is a near-linear systematic bias (PERF.md drift landscape),
    so a partial run still normalizes meaningfully to per-1e4 steps."""
    from pypic_tpu.runner import run

    t0 = time.perf_counter()
    st = state
    tot0 = tot1 = None
    done = 0  # sim steps
    calls_per_chunk = max(1, 1000 // spc)
    chunk_cost = 0.0
    while done < drift_steps:
        if (budget_s is not None and done > 0
                and time.perf_counter() - t0 + chunk_cost > budget_s):
            print(f"bench: drift loop stopping at {done} steps "
                  f"(budget {budget_s:.0f}s)", file=sys.stderr)
            break
        tc = time.perf_counter()
        calls = min(calls_per_chunk, -(-(drift_steps - done) // spc))
        st, m2 = run(step, st, calls)
        tot = (
            np.asarray(m2.field_energy, np.float64)
            + np.asarray(m2.kinetic_energy, np.float64)
        ).reshape(-1)
        # estimate the NEXT chunk from the cheapest seen: the first chunk
        # carries the compile and would otherwise veto a loop whose
        # steady-state chunks still fit the budget comfortably
        cost = time.perf_counter() - tc
        chunk_cost = cost if chunk_cost == 0.0 else min(chunk_cost, cost)
        if tot0 is None:
            tot0 = tot[0]
        print(f"  drift chunk [{done}-{done + calls * spc}): "
              f"{(tot[-1] - tot[0]) / tot0:+.3e}", file=sys.stderr)
        tot1 = tot[-1]
        done += calls * spc
    drift = (tot1 - tot0) / tot0
    print(f"bench: energy drift over {done} steps: {drift:.3e}",
          file=sys.stderr)
    return float(drift), done


# The conserving configuration: a fixed 4 Picard sweeps (tol 1e-30 never
# exits early), extrapolated initial iterate and Anderson mixing — <1e-3
# drift per 1e4 steps across seeds and at 1e8 (PERF.md drift table).
CONSERVING = dict(tol=1e-30, maxiter=4, picard_init="extrapolate",
                  picard_accel="anderson")


def landau_problem(n, **cfg_kw):
    """The headline workload: the reference's Landau preset at n particles,
    loaded on the device. ``cfg_kw`` go to ImplicitConfig (tol, maxiter,
    picard_init, finalize, picard_accel, finalize_field, picard_impl).
    Returns (grid, x, v, cfg)."""
    import jax
    import jax.numpy as jnp

    from pypic_tpu.constants import (
        E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON,
    )
    from pypic_tpu.grid import GridSpec
    from pypic_tpu.engines import implicit

    # Reference Landau preset (pypic.py:846-855).
    density = 1e5
    te = 100.0 * 11600.0
    ng = 200
    dt = 1e-5
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    length = 22.0 * debye
    grid = GridSpec(ng, length, "periodic")
    p2c = length * density / n

    # Device-side load: Maxwellian velocities and the cosine density
    # perturbation applied as a position displacement (same perturbation
    # amplitude as the reference's resampling loader).
    vth = np.sqrt(2.0 * K_BOLTZMANN * te / M_ELECTRON)
    kx, kv = jax.random.split(jax.random.PRNGKey(1))
    x = jax.random.uniform(kx, (n,), jnp.float32, 0.0, np.float32(length))
    v = jax.random.normal(kv, (n,), jnp.float32) * np.float32(vth / np.sqrt(2.0))
    k_pert = 2.0 * np.pi / length
    x = x + np.float32(0.8 / k_pert) * jnp.sin(k_pert * x) * 0.5
    cfg = implicit.ImplicitConfig(grid, dt, p2c, **cfg_kw)
    return grid, x, v, cfg


def _landau_problem(n, tol, maxiter=50):
    """landau_problem with this run's Picard settings (the flags)."""
    return landau_problem(n, tol=tol, maxiter=maxiter,
                          picard_init=_PICARD_INIT, finalize=_FINALIZE,
                          picard_accel=_ACCEL,
                          finalize_field=_FINALIZE_FIELD)


def bench_headline(args):
    import jax

    from pypic_tpu.constants import E_CHARGE, M_ELECTRON
    from pypic_tpu.engines import implicit
    from pypic_tpu.runner import run

    n = args.particles or 100_000_000
    grid, x, v, cfg = _landau_problem(n, args.tol, maxiter=args.maxiter)
    state = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
    print(f"bench: platform={jax.devices()[0].platform} n={n:.2e} "
          f"ng={grid.ng} steps={args.steps}", file=sys.stderr)

    step = implicit.make_step(cfg)
    if not args.drift_only:
        holder = {}

        def go():
            _, m = run(step, state, args.steps)
            np.asarray(m.field_energy)
            holder["m"] = m

        elapsed = _time(go)
        m = holder["m"]
        iters = np.asarray(m.picard_iters)
        _emit("headline", n, args.steps, elapsed,
              f"(picard mean {iters.mean():.1f}, "
              f"EE[0]={np.asarray(m.field_energy)[0]:.3e})")

    if args.drift_steps:
        # The accuracy clause of the two-clause north star (BASELINE.json:
        # >=1e9 pushes/s AND <0.1%/1e4 energy drift), machine-readable in
        # the same artifact stream as the throughput rows.
        drift, covered = _drift_loop(step, state, args.drift_steps,
                                     budget_s=args.drift_budget_s or None)
        rec = {
            "metric": "headline_energy_drift",
            "drift": drift,
            "drift_steps": covered,
            "drift_per_1e4": drift * 1e4 / covered if covered else None,
            "config": ("conserving" if args.tol <= 1e-29 else
                       f"tol={args.tol:g}"),
        }
        print(json.dumps(rec))


def bench_two_stream(args):
    """configs[0]: explicit two-stream at ~1e4 particles."""
    import numpy as np

    from pypic_tpu.constants import (
        E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON,
    )
    from pypic_tpu.grid import GridSpec
    from pypic_tpu import initialize as init
    from pypic_tpu.engines import explicit
    from pypic_tpu.runner import run

    # small n: the row is per-step dispatch and launch cost, amortized over
    # many steps in one scanned dispatch
    n, steps = 10_000, args.row_steps or 40_000
    density = 1e10
    te = 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(200, 15.0 * debye, "periodic")
    x, v, params = init.initialize_periodic(
        "two-stream", n, density, 1, 0.05, grid, te, te, seed=2
    )
    cfg = explicit.ExplicitConfig(grid, 0.1 / params.wp, params.p2c)
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)

    step = explicit.make_step(cfg)

    def go():
        _, m = run(step, st, steps)
        np.asarray(m.field_energy)

    _emit("two_stream", n, steps, _time(go))


def bench_landau(args):
    """configs[1]: Landau damping at 1e5 particles, damping rate checked."""
    from pypic_tpu.constants import E_CHARGE, M_ELECTRON
    from pypic_tpu.engines import implicit
    from pypic_tpu.runner import run

    n, steps = 100_000, args.row_steps or 16_000
    grid, x, v, cfg = _landau_problem(n, 1e-6)
    state = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
    step = implicit.make_step(cfg)

    def go():
        _, m = run(step, state, steps)
        np.asarray(m.field_energy)

    _emit("landau", n, steps, _time(go))


def bench_sheath(args):
    """configs[2]: bounded 2-species sheath at 1e6 (PIC_L_DD.py:320-331)."""
    from pypic_tpu.constants import K_BOLTZMANN
    from pypic_tpu.grid import GridSpec
    from pypic_tpu import initialize as init
    from pypic_tpu.engines import sheath
    from pypic_tpu.runner import run

    n, steps, ng = args.sheath_n or 1_000_000, args.row_steps or 1200, 51
    density, dt, dx = 1e19, 1e-12, 1e-5
    te = ti = 10.0 * 11600.0
    length = dx * (ng - 1)
    grid = GridSpec(ng, length, "dirichlet-dirichlet")
    d = init.initialize_sheath(n, density, 1.0, 0.0, grid, te, ti, seed=3)
    # extrapolated init + Anderson(1) mixing + the default f32
    # residual-floor exit (tol_floor): same fixed point, ~5 mean Picard
    # iterations instead of 13.6 grinding round-off (PERF.md round 3)
    cfg = sheath.SheathConfig(
        grid, dt, length * density / n,
        kbte=K_BOLTZMANN * te, kbti=K_BOLTZMANN * ti,
        picard_init="extrapolate", picard_accel="anderson",
    )
    st = sheath.init_state(d["x"], d["v"], d["q"], d["m"], d["species"], cfg)
    step = sheath.make_step(cfg)

    def go():
        _, m = run(step, st, steps)
        np.asarray(m.field_energy)

    _emit("sheath", n, steps, _time(go))


def bench_magnetized(args):
    """configs[3]: magnetized Boris + Newton-Boltzmann + IEAD at 1e6
    (pic_iead workload, pygcpic.py:1120-1305)."""
    from pypic_tpu.presets import pic_iead
    from pypic_tpu.engines import magnetized
    from pypic_tpu.runner import run

    steps = args.row_steps or 1200
    pre = pic_iead(n_per_species=(args.mag_n or 1_000_000) // 6)
    n = pre.state.p.shape[0]
    step = magnetized.make_step(pre.config)

    def go():
        _, m = run(step, pre.state, steps)
        np.asarray(m.phi_max)

    _emit("magnetized", n, steps, _time(go))


def bench_domain(args):
    """configs[4]: domain-decomposed implicit at 1e8 over the device mesh
    (slab-sharded fields + halo exchange + migration; the mesh is every
    device this host exposes)."""
    import jax

    from pypic_tpu.constants import E_CHARGE, M_ELECTRON
    from pypic_tpu.parallel import domain_implicit as di, make_mesh
    from pypic_tpu.runner import run

    n = args.particles or 100_000_000
    steps = 30
    n_dev = len(jax.devices())
    grid, x, v, _ = _landau_problem(n, args.tol)
    # halo from physics: worst-case intra-step excursion is ~|v| dt / dx;
    # cover an 8-sigma Maxwellian tail (halo=4 measured 113k clamps per 1e9
    # pushes on this workload — sigma here is ~1.1 cells/step)
    sigma_cells = float(np.asarray(v).std()) * 1e-5 / grid.dx
    halo = min(grid.ng // n_dev - 3, max(4, int(np.ceil(8.0 * sigma_cells))))
    cfg = di.DomainImplicitConfig(
        grid, 1e-5, grid.length * 1e5 / n, num_shards=n_dev,
        tol=args.tol, maxiter=args.maxiter, halo=halo,
        picard_init=_PICARD_INIT, finalize=_FINALIZE, picard_accel=_ACCEL,
        finalize_field=_FINALIZE_FIELD,
        migrate_cap=max(4096, 4 * (n // max(1, grid.ng))),
    )
    k_mig = max(1, args.migrate_every)
    if k_mig > 1:
        # identical physics to the k=1 row modulo the two real deltas: a
        # halo covering k steps of excursion (clamps warned-on below) and a
        # migrate buffer sized for k steps of traffic
        import dataclasses

        cfg = dataclasses.replace(
            cfg,
            halo=min(grid.ng // n_dev - 3, k_mig * halo),
            migrate_cap=max(4096, 4 * k_mig * (n // max(1, grid.ng))),
        )
    mesh = make_mesh(n_dev, axis="slabs")
    # Capacity headroom: every sweep processes capacity rows, so slack is a
    # direct throughput tax. One shard has no load imbalance (5% covers
    # migration-buffer churn); multi-shard keeps the default 1.5x because
    # the perturbation-0.8 workload piles particles into wave-crest slabs.
    # Overflow is counted (n_dropped), never silent.
    st = di.shard_state(
        di.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg,
                      capacity_factor=1.05 if n_dev == 1 else 1.5),
        mesh, cfg)
    if k_mig > 1:
        step = di.make_superstep(cfg, mesh, k_mig)
        steps = max(1, steps // k_mig)
    else:
        step = di.make_step(cfg, mesh)

    holder = {}

    def go():
        _, m = run(step, st, steps)
        np.asarray(m.field_energy)
        holder["m"] = m

    elapsed = _time(go)
    m = holder["m"]
    steps *= k_mig  # micro-steps actually executed (pushes for _emit)
    n_clamped = int(np.asarray(m.n_halo_clamped).sum())
    _emit("domain", n, steps, elapsed,
          f"(shards={n_dev}, migrate_every={k_mig}, "
          f"dropped={int(np.asarray(m.n_dropped).sum())}, "
          f"halo_clamped={n_clamped})")
    if n_clamped:
        print(f"# WARNING: {n_clamped} halo clamps — the superstep halo "
              "does not cover the k-step excursion; this row is not "
              "physics-equivalent to the per-step one", file=sys.stderr)

    if args.drift_steps:
        # North-star drift for configs[4] (the domain-decomposed flagship):
        # same chunked protocol as the headline row, in SIM steps.
        _drift_loop(step, st, args.drift_steps, spc=k_mig)


def bench_domain_explicit(args):
    """The explicit leapfrog cycle domain-decomposed at 1e8 (parallel.domain;
    no BASELINE config of its own — measured for the multi-chip explicit
    story next to the single-device one-kernel cycle)."""
    import jax

    from pypic_tpu.constants import E_CHARGE, M_ELECTRON
    from pypic_tpu.parallel import domain as dom, make_mesh
    from pypic_tpu.runner import run

    n = args.particles or 100_000_000
    steps = 30
    n_dev = len(jax.devices())
    grid, x, v, _ = _landau_problem(n, args.tol)
    k_mig = max(1, args.migrate_every)
    sigma_cells = float(np.asarray(v).std()) * 1e-5 / grid.dx
    halo = (0 if k_mig == 1 else
            min(grid.ng // n_dev - 1,
                max(4, k_mig * int(np.ceil(8.0 * sigma_cells)))))
    cfg = dom.DomainConfig(
        grid, 1e-5, grid.length * 1e5 / n, num_shards=n_dev, halo=halo,
        migrate_cap=max(4096, 4 * k_mig * (n // max(1, grid.ng))),
        field_solve=args.field_solve,
    )
    mesh = make_mesh(n_dev, axis="slabs")
    st = dom.shard_state(
        dom.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg,
                       capacity_factor=1.05 if n_dev == 1 else 1.5),
        mesh, cfg)
    if k_mig > 1:
        step = dom.make_superstep(cfg, mesh, k_mig)
        steps = max(1, steps // k_mig)
    else:
        step = dom.make_step(cfg, mesh)

    holder = {}

    def go():
        _, m = run(step, st, steps)
        np.asarray(m.field_energy)
        holder["m"] = m

    elapsed = _time(go)
    m = holder["m"]
    steps *= k_mig
    n_clamped = int(np.asarray(m.n_halo_clamped).sum())
    _emit("domain_explicit", n, steps, elapsed,
          f"(shards={n_dev}, migrate_every={k_mig}, "
          f"dropped={int(np.asarray(m.n_dropped).sum())}, "
          f"halo_clamped={n_clamped})")
    if n_clamped:
        print(f"# WARNING: {n_clamped} halo clamps — the superstep halo "
              "does not cover the k-step excursion; this row is not "
              "physics-equivalent to the per-step one", file=sys.stderr)


def _forward_flags(args):
    """Child argv for `--only <row>` subprocesses: every knob that shapes a
    row, with the parent's resolved values (so --throughput resolution
    happens once, in the parent)."""
    fwd = ["--tol", repr(args.tol), "--maxiter", str(args.maxiter),
           "--picard-init", args.picard_init, "--finalize", args.finalize,
           "--picard-accel", args.picard_accel,
           "--finalize-field", args.finalize_field,
           "--migrate-every", str(args.migrate_every),
           "--field-solve", args.field_solve,
           "--steps", str(args.steps)]
    if args.particles:
        fwd += ["--particles", str(args.particles)]
    if args.row_steps:
        fwd += ["--row-steps", str(args.row_steps)]
    if args.sheath_n:
        fwd += ["--sheath-n", str(args.sheath_n)]
    if args.mag_n:
        fwd += ["--mag-n", str(args.mag_n)]
    return fwd


# the in-flight row child, so the SIGTERM handler can kill its whole
# process group instead of orphaning a GPU-holding subprocess
_CURRENT_CHILD = {"proc": None}


def _kill_child_group(proc):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        pass


def _run_child(name, fwd, backend_flags, timeout_s, extra=()):
    """Run one matrix row in a fresh process: `bench.py --only <name>`.
    Returns (json_records, stderr_text, error_or_None). Rows run one at a
    time, so only one JAX process holds the GPU, and its device memory is
    released when the process exits — a 1e8 row can never starve the next
    row's allocation. The child runs in its own session so a timeout (or
    the parent's SIGTERM handler) can SIGKILL the whole group — a hung
    row must not leave an orphan holding the GPU."""
    cmd = ([sys.executable, os.path.abspath(__file__), "--only", name]
           + list(extra) + fwd + backend_flags)
    err = None
    # block termination signals across spawn+track so a SIGTERM can never
    # land between Popen returning and the child becoming killable via
    # _CURRENT_CHILD (it would orphan a chip-holding child); the pending
    # signal delivers right after the mask is restored
    mask = signal.pthread_sigmask(
        signal.SIG_BLOCK, {signal.SIGTERM, signal.SIGINT})
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        _CURRENT_CHILD["proc"] = proc
    except OSError as e:
        return [], "", f"spawn failed: {e!r}"
    finally:
        signal.pthread_sigmask(signal.SIG_SETMASK, mask)
    try:
        out, serr = proc.communicate(timeout=timeout_s)
        out, serr = out or "", serr or ""
        if proc.returncode != 0:
            tail = [ln for ln in serr.strip().splitlines() if ln.strip()]
            err = (f"rc={proc.returncode}: "
                   f"{tail[-1][:300] if tail else '?'}")
    except subprocess.TimeoutExpired:
        _kill_child_group(proc)
        try:
            out, serr = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            out, serr = "", ""
        out, serr = out or "", serr or ""
        err = f"timeout after {timeout_s:.0f}s"
    finally:
        _CURRENT_CHILD["proc"] = None
    recs = []
    for ln in out.splitlines():
        ln = ln.strip()
        if ln.startswith("{"):
            try:
                rec = json.loads(ln)
            except ValueError:
                continue
            if isinstance(rec, dict) and "metric" in rec:
                recs.append(rec)
    if err is None and not recs:
        err = "no JSON row in child stdout"
    return recs, serr, err


def _replay_child_stderr(serr):
    """Echo the child's stderr so the driver's tail keeps the familiar
    per-row progress lines. Callers replay AFTER recording the child's
    rows into the artifact, so an external watcher that reacts to a
    progress line (or a SIGTERM racing it) can never observe the line
    without the artifact entry behind it."""
    if serr:
        sys.stderr.write(serr if serr.endswith("\n") else serr + "\n")


# per-row wall reserves for the budget guard (compile-dominated, plus the
# child's backend start-up). A row starts only while at least this much
# budget remains; the 1e8 domain rows compile the biggest programs.
_RESERVE = {"domain": 300.0, "domain_explicit": 240.0,
            "landau": 150.0, "two_stream": 150.0}
# drift child: start-up + compile + at least one chunk of 1000 steps
_DRIFT_MIN_S = 180.0
# full drift child wall cost (start-up + compile + 10 chunks of 1000
# steps); the early (post-headline) drift slot runs only while this much
# budget PLUS the flagship rows' reserves remain
_DRIFT_FULL_S = 600.0


def _run_drift_child(args, art, fwd, backend_flags, drift_budget,
                     timeout_s):
    """Run the accuracy-clause child (`--only headline --drift-only`) and
    fold its record into the artifact. Returns True only when a drift
    NUMBER was recorded — a failed early attempt leaves its FAILED marker
    but lets the end-of-run slot retry with whatever budget remains."""
    recs, serr, err = _run_child(
        "headline", fwd, backend_flags, timeout_s,
        extra=["--drift-only", "--drift-steps", str(args.drift_steps),
               "--drift-budget-s", f"{drift_budget:.0f}"])
    drec = next((r for r in recs
                 if r.get("metric") == "headline_energy_drift"), None)
    if drec is None:
        art["drift_per_1e4"] = f"FAILED ({err or 'no drift record'})"
    else:
        art["drift_per_1e4"] = drec["drift_per_1e4"]
        art["drift_steps"] = drec["drift_steps"]
        art["drift_config"] = drec.get("config")
    _replay_child_stderr(serr)
    if drec is None:
        print(f"bench[drift] FAILED: {err}", file=sys.stderr)
    return drec is not None


def _run_matrix_isolated(args, backend_flags):
    """Driver default: measure the WHOLE matrix, one subprocess per row,
    and print ONE combined JSON line (headline + "rows" + skipped/failed +
    the drift clause). Each row gets a fresh process — the round-4 OOM
    cascade (headline's server-side buffers survived every in-process
    teardown and starved all six following rows) is structurally
    impossible here. The headline row always runs; further rows start only
    while enough budget remains for their typical compile+run; whatever
    the budget or a SIGTERM cuts off is listed, never silently absent."""
    t_start = time.perf_counter()
    fwd = _forward_flags(args)

    art = {"metric": "particle_pushes_per_sec_per_chip", "value": 0.0,
           "unit": "pushes/s [headline row FAILED — see stderr]",
           "vs_baseline": 0.0, "rows": {}}
    done = {"printed": False}

    def _finalize_and_print():
        if done["printed"]:
            return
        done["printed"] = True  # reentrancy guard (a second SIGTERM
        # during the print must not double-emit)
        line = json.dumps(art)
        try:
            print(line)
            sys.stdout.flush()
        except (BrokenPipeError, OSError):
            # the driver closed our stdout (it timed us out) — best
            # effort: the artifact is still worth having in the stderr
            # tail rather than nowhere
            try:
                sys.stderr.write(line + "\n")
                sys.stderr.flush()
            except OSError:
                pass

    def _on_term(signum, frame):
        # driver timeout / operator interrupt: kill the in-flight child's
        # process group (an orphan would keep holding the GPU), then ship
        # the partial artifact rather than nothing — a truncated matrix
        # with a "skipped" list is strictly better evidence than none
        proc = _CURRENT_CHILD.get("proc")
        if proc is not None:
            _kill_child_group(proc)
        for name in order:
            if name not in art["rows"] and name not in failed \
                    and name not in skipped and name != "headline":
                skipped.append(name)
        if skipped:
            art["skipped"] = sorted(set(skipped))
        if failed:
            art["failed"] = failed
            art["failed_detail"] = failed_detail
        art.setdefault("interrupted", signal.Signals(signum).name)
        _finalize_and_print()
        os._exit(1)

    # importance order: headline first (must always record), then the
    # configs[4] flagship domain rows, then the small rows — budget
    # exhaustion drops the LEAST informative evidence first
    order = ["headline", "domain", "domain_explicit", "magnetized",
             "sheath", "landau", "two_stream"]
    failed, skipped, failed_detail = [], [], {}
    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)

    for name in order:
        left = args.budget_s - (time.perf_counter() - t_start)
        if name != "headline" and left < _RESERVE.get(name, 120.0):
            skipped.append(name)
            print(f"bench[{name}]: SKIPPED ({left:.0f}s budget left)",
                  file=sys.stderr)
            continue
        # per-child hard cap: one hung row may not eat the whole matrix
        # budget
        timeout_s = min(900.0, max(180.0, left + 60.0))
        recs, serr, err = _run_child(name, fwd, backend_flags, timeout_s)
        row = next((r for r in recs if r.get("metric", "").startswith(
            ("particle_" if name == "headline" else name + "_"))), None)
        if row is None:
            # record-before-replay here too: a SIGTERM racing the replay
            # must find the failure already filed
            failed.append(name)
            failed_detail[name] = err or "no row record"
            _replay_child_stderr(serr)
            print(f"bench[{name}] FAILED: {err}", file=sys.stderr)
            continue
        if err is not None:
            # the child printed a complete measurement and THEN died or
            # hung — keep the real row, annotated, instead of discarding
            # evidence
            row["child_error"] = err
        if name == "headline":
            art.update(row)
            art.setdefault("rows", {})
        else:
            art["rows"][name] = row
        _replay_child_stderr(serr)
        if err is not None:
            print(f"bench[{name}]: row recorded, child then failed "
                  f"({err})", file=sys.stderr)
        if name == "headline" and args.drift_steps:
            # the accuracy clause is half the two-clause north star —
            # run it SECOND, right after the headline, so a later stall
            # can only cost secondary rows, never the drift number. On a
            # short budget defer it to the end so the flagship rows keep
            # their reserves.
            left = args.budget_s - (time.perf_counter() - t_start)
            # threshold: a full drift pass + the flagship domain row's
            # reserve
            if left > _DRIFT_FULL_S + _RESERVE["domain"]:
                budget = min(520.0, left - 420.0)
                # timeout = loop budget + init/compile margin: the early
                # slot gives up rather than starving every later row
                done["drift"] = _run_drift_child(
                    args, art, fwd, backend_flags, drift_budget=budget,
                    timeout_s=budget + 240.0)

    # the accuracy clause (a second pass if the early slot didn't run it)
    if args.drift_steps and not done.get("drift"):
        left = args.budget_s - (time.perf_counter() - t_start)
        if "headline" in failed:
            art["drift_per_1e4"] = "skipped (headline row failed)"
        elif left < _DRIFT_MIN_S:
            art["drift_per_1e4"] = f"skipped (budget: {left:.0f}s left)"
            print(f"bench[drift]: SKIPPED ({left:.0f}s budget left)",
                  file=sys.stderr)
        else:
            _run_drift_child(args, art, fwd, backend_flags,
                             drift_budget=max(60.0, left - 120.0),
                             timeout_s=min(1800.0, max(240.0, left + 60.0)))

    if skipped:
        art["skipped"] = skipped
    if failed:
        art["failed"] = failed
        art["failed_detail"] = failed_detail
    _finalize_and_print()
    if art.get("value", 0.0) <= 0.0:
        sys.exit(1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--steps", type=int, default=20)  # headline row
    ap.add_argument("--throughput", action="store_true",
                    help="run the throughput configuration (tol 1e-9, "
                         "unmixed) instead of the default conserving one "
                         "(fixed-4 + extrapolate + Anderson, <1e-3/1e4 "
                         "drift; PERF.md)")
    ap.add_argument("--tol", type=float, default=None,
                    help="Picard tolerance (default: the conserving "
                         "config's 1e-30 fixed-count mode, or 1e-9 with "
                         "--throughput; reference parity is 1e-3, which "
                         "does NOT conserve energy on this workload — see "
                         "PERF.md's drift landscape)")
    ap.add_argument("--maxiter", type=int, default=None,
                    help="Picard iteration cap (with --tol 1e-30: a fixed "
                         "count; default 4 [conserving] / 50 [--throughput])")
    ap.add_argument("--row-steps", type=int, default=0,
                    help="two_stream/landau/sheath/magnetized rows: "
                         "override the timed step count (the rows run as "
                         "one scanned dispatch, so per-dispatch cost is "
                         "amortized over the step count; also the "
                         "CPU-smoke knob)")
    ap.add_argument("--sheath-n", type=int, default=0,
                    help="sheath row: override the particle count "
                         "(CPU-smoke knob, like --mag-n)")
    ap.add_argument("--drift-steps", type=int, default=None,
                    help="measure energy drift over this many steps "
                         "(default: 10000 in the driver-default combined "
                         "mode — the artifact's accuracy clause — and off "
                         "for --only/--all)")
    ap.add_argument("--drift-only", action="store_true",
                    help="with --only headline: skip the throughput "
                         "timing, run just the drift protocol (the "
                         "default mode's drift child)")
    ap.add_argument("--drift-budget-s", type=float, default=0.0,
                    help="wall-clock bound on the drift loop; a partial "
                         "run reports the steps it covered and normalizes "
                         "per 1e4")
    ap.add_argument("--all", action="store_true",
                    help="run the full BASELINE.md config matrix "
                         "IN-PROCESS, one JSON line per row (the DEFAULT "
                         "runs each row in an isolated subprocess and "
                         "folds the matrix into one combined JSON line)")
    ap.add_argument("--budget-s", type=float, default=1380.0,
                    help="default mode: wall-clock budget; non-headline "
                         "rows start only while enough remains for their "
                         "typical compile+run (skipped rows are listed in "
                         "the JSON artifact); whatever remains after the "
                         "rows bounds the drift clause")
    ap.add_argument("--only", default=None,
                    choices=("two_stream", "landau", "sheath", "magnetized",
                             "domain", "domain_explicit", "headline"),
                    help="run a single named matrix config")
    ap.add_argument("--picard-init", default="extrapolate",
                    choices=("field", "extrapolate", "extrapolate2"),
                    help="Picard initial iterate (see ImplicitConfig; "
                         "extrapolate = same fixed point/tolerance, ~1 fewer "
                         "iteration; 'field' = the reference's E0 start)")
    ap.add_argument("--finalize", default="converged",
                    choices=("converged", "converged-deposit", "iterate"),
                    help="step finalize (see ImplicitConfig.finalize; "
                         "'converged' = deposit-free conserving sweep from "
                         "the converged field [default]; 'iterate' = the "
                         "reference's last-iterate return, fastest but "
                         "~5x the energy drift on the violent headline "
                         "workload)")
    ap.add_argument("--picard-accel", default=None,
                    choices=("none", "anderson", "anderson2", "damped"),
                    help="Picard iterate mixing (see ImplicitConfig; "
                         "default anderson [conserving] / none "
                         "[--throughput])")
    ap.add_argument("--migrate-every", type=int, default=1,
                    help="domain row: amortize wrap+migration over this "
                         "many CN-Picard micro-steps per superstep "
                         "(make_superstep; halo scales by the same factor "
                         "so k-step excursions stay covered)")
    ap.add_argument("--field-solve", default="replicated",
                    choices=("replicated", "distributed"),
                    help="domain_explicit row: Poisson solve layout "
                         "(DomainConfig.field_solve; 'distributed' = "
                         "tridiagonal substructuring across slabs — the "
                         "multi-device A/B for large ng)")
    ap.add_argument("--mag-n", type=int, default=0,
                    help="magnetized row: total particle count override "
                         "(default 1e6 — the BASELINE configs[3] scale; "
                         "small values for CPU smoke runs)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU: a wiring smoke test whose rows "
                         "say [cpu] in their unit, never a measurement")
    ap.add_argument("--finalize-field", default="last",
                    choices=("last", "mean2", "map", "aitken"),
                    help="field the finalize sweep gathers with (see "
                         "ImplicitConfig.finalize_field; 'mean2' averages "
                         "the last two Picard map outputs, 'map' is the "
                         "raw Ampere-consistent eh_k, 'aitken' the Δ² "
                         "extrapolation of the last three map outputs)")
    args = ap.parse_args()
    from pypic_tpu.platform import compile_cache, gpu_name_and_power_limit

    compile_cache()
    global _CPU_SMOKE
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
        _CPU_SMOKE = True
    # Resolve the headline/domain configuration: conserving by default
    # (both north-star clauses at once), throughput on request.
    if args.tol is None:
        args.tol = 1e-9 if args.throughput else CONSERVING["tol"]
    if args.maxiter is None:
        args.maxiter = 50 if args.throughput else CONSERVING["maxiter"]
    if args.picard_accel is None:
        args.picard_accel = ("none" if args.throughput
                             else CONSERVING["picard_accel"])
    global _PICARD_INIT, _FINALIZE, _ACCEL, _FINALIZE_FIELD
    _PICARD_INIT = args.picard_init
    _FINALIZE = args.finalize
    _ACCEL = args.picard_accel
    _FINALIZE_FIELD = args.finalize_field

    matrix = {
        "two_stream": bench_two_stream,
        "landau": bench_landau,
        "sheath": bench_sheath,
        "magnetized": bench_magnetized,
        "domain": bench_domain,
        "domain_explicit": bench_domain_explicit,
        "headline": bench_headline,
    }
    if args.only:
        if not args.cpu:
            _require_gpu()
        if args.drift_steps is None:
            # --drift-only with no explicit count means the full protocol
            # (a bare default of 0 would silently print nothing)
            args.drift_steps = 10_000 if args.drift_only else 0
        if os.environ.get("PYPIC_BENCH_TEST_FAIL_ROW") == args.only:
            # test hook: the isolation smoke test injects a row death to
            # prove one row's failure can't take the tail
            raise SystemExit(f"injected test failure for row {args.only}")
        matrix[args.only](args)
    elif args.all:
        if not args.cpu:
            _require_gpu()
        if args.drift_steps is None:
            args.drift_steps = 0
        # one row's failure must not abort the rest of the matrix;
        # executables are dropped between rows
        failed = []
        for name, fn in matrix.items():
            try:
                fn(args)
            except Exception as e:
                failed.append(name)
                print(f"bench[{name}] FAILED: {e!r}", file=sys.stderr)
            finally:
                import gc

                import jax

                jax.clear_caches()
                gc.collect()
        if failed:
            print(f"bench: {len(failed)} row(s) failed: {failed}",
                  file=sys.stderr)
            sys.exit(1)
    else:
        # Driver default: the whole matrix, one isolated subprocess per
        # row, composed into ONE JSON line (headline + "rows" + the drift
        # clause + skipped/failed). The parent never initializes a jax
        # backend — rows cannot share (or starve) device memory — so it
        # asks nvidia-smi, not JAX, whether there is a GPU.
        if args.drift_steps is None:
            args.drift_steps = 10_000
        if not args.cpu and gpu_name_and_power_limit() is None:
            raise SystemExit("bench: no NVIDIA GPU found (nvidia-smi lists "
                             "none); pass --cpu for a wiring smoke test")
        _run_matrix_isolated(args, ["--cpu"] if args.cpu else [])


if __name__ == "__main__":
    main()
