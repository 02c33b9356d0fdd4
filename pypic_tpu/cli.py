"""Command-line driver: run presets, write diagnostics/plots/gifs.

The L10 layer — replaces the reference run scripts (run_pypic.py,
run_pypic_dd.py): clear the plot directory, run the simulation with wall-clock
timing written to ``time.out`` (run_pypic.py:12-17), dump the text outputs
(pypic.py:637-648), render summary frames and assemble gifs (convert.py).

Usage:
    python -m pypic_tpu.cli run landau_damping --steps 1000 --plot-every 100
    python -m pypic_tpu.cli list
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np


def _cmd_list(_args):
    from . import presets

    for name in sorted(presets.PRESETS):
        fn = presets.PRESETS[name]
        doc = (fn.__doc__ or "").strip().splitlines()[0]
        print(f"{name:24s} {doc}")


def _cmd_run(args):
    import jax

    from . import checkpoint, diagnostics, platform, presets
    from .parallel.mesh import maybe_initialize_distributed
    from .runner import run, run_thinned

    platform.compile_cache()

    # env-gated multi-host bootstrap (PYPIC_COORDINATOR /
    # PYPIC_DISTRIBUTED=1): must run before any backend use so sharded
    # presets see the GLOBAL device list; a no-op single-host
    if maybe_initialize_distributed():
        print(f"distributed: process {jax.process_index()} of "
              f"{jax.process_count()}, {len(jax.devices())} global devices",
              file=sys.stderr)

    pkw = {}
    if args.particles:
        pkw["n"] = args.particles
    if getattr(args, "shards", None):
        pkw["shards"] = args.shards
    if getattr(args, "replicas", None):
        pkw["replicas"] = args.replicas
    if getattr(args, "migrate_every", 0) and args.migrate_every > 1:
        pkw["migrate_every"] = args.migrate_every
    for kv in getattr(args, "opt", None) or []:
        key, sep, val = kv.partition("=")
        if not sep or not key:
            sys.exit(f"--opt expects KEY=VALUE, got {kv!r}")
        try:
            val = int(val)
        except ValueError:
            try:
                val = float(val)
            except ValueError:
                pass
        pkw[key.replace("-", "_")] = val
    try:
        preset = presets.get(args.preset, **pkw)
    except TypeError as e:
        # only claim a bad key when the error really is one (a TypeError
        # raised INSIDE the preset body must surface its own traceback)
        if "unexpected keyword argument" in str(e):
            if "migrate_every" in pkw:
                sys.exit(f"--migrate-every is not supported by preset "
                         f"{args.preset!r} (domain presets only)")
            if getattr(args, "opt", None):
                sys.exit(f"an --opt key is not accepted by preset "
                         f"{args.preset!r} (see its signature in presets.py)")
        raise
    # migration-amortized supersteps (domain presets): one step() call
    # advances spc sim steps and stacks a (spc,) axis on the metrics
    spc = int(preset.meta.get("steps_per_call", 1))
    if "migrate_every" in pkw and spc != pkw["migrate_every"]:
        # a **kw preset would otherwise swallow the flag silently and the
        # user would believe they measured the superstep when they did not
        sys.exit(f"--migrate-every is not supported by preset "
                 f"{args.preset!r} (domain presets only)")
    n_calls = args.steps
    if spc > 1:
        n_calls = -(-args.steps // spc)
        if n_calls * spc != args.steps:
            print(f"steps rounded up to {n_calls * spc} "
                  f"(multiple of --migrate-every {spc})", file=sys.stderr)
        args.steps = n_calls
        if args.plot_every:
            print("plot-every unsupported with --migrate-every; keeping "
                  "full-cadence metrics", file=sys.stderr)
            args.plot_every = 0
    outdir = args.outdir
    if os.path.isdir(outdir) and args.clean:
        shutil.rmtree(outdir)
    os.makedirs(outdir, exist_ok=True)

    step = preset.make_step()
    state = preset.state
    mgr = None
    if args.checkpoint_every:
        mgr = checkpoint.CheckpointManager(
            os.path.join(outdir, "checkpoints"), every=args.checkpoint_every,
            async_write=args.async_checkpoint,
        )
        if args.resume:
            state, manifest = mgr.restore(
                state,
                migrate=getattr(preset.engine, "CHECKPOINT_MIGRATIONS", None),
            )
            print(f"resumed from step {manifest['step']}", file=sys.stderr)
            # a checkpoint from before the explicit engine carried rho/e
            # restores those leaves from the template (a different particle
            # configuration) — recompute them from the restored positions
            from .engines import explicit as _explicit

            if (preset.engine is _explicit
                    and ".rho" not in manifest.get("leaf_paths", [])):
                state = _explicit.refresh_fields(state, preset.config)
                print("refreshed carried rho/e from restored positions",
                      file=sys.stderr)
            # implicit/sheath states gained e_prev/e_prev2 (the extrapolated
            # Picard-init history); a pre-history checkpoint restores those
            # from the template's step-0 fields, perturbing the first steps'
            # Picard starting guess — seed them from the restored e instead
            # (equivalent to picard_init='field' on the first resumed step)
            leaf_paths = manifest.get("leaf_paths", [])
            refresh = {}
            for name in ("e_prev", "e_prev2"):
                if (hasattr(state, name) and hasattr(state, "e")
                        and f".{name}" not in leaf_paths):
                    refresh[name] = state.e
            # magnetized: phi_prev (round-3 extrapolated Newton warm start)
            if (hasattr(state, "phi_prev") and hasattr(state, "phi")
                    and ".phi_prev" not in leaf_paths):
                refresh["phi_prev"] = state.phi
            if refresh:
                state = state.replace(**refresh)
                print(f"seeded {sorted(refresh)} from the restored field "
                      "(pre-history checkpoint)", file=sys.stderr)
            # sharded presets (domain_implicit) restore to host arrays;
            # re-place them on the device mesh before stepping
            reshard = preset.meta.get("reshard")
            if reshard is not None:
                state = reshard(state)

    def _run_span(state, steps, thin):
        if thin:
            return run_thinned(step, state, steps, args.plot_every)
        return run(step, state, steps)

    if args.profile:
        # jax.profiler trace for TensorBoard/Perfetto (SURVEY.md §5: the
        # reference's only tracing is a wall-clock timer, run_pypic.py:13-17)
        profile_dir = os.path.join(outdir, "profile")
        jax.profiler.start_trace(profile_dir)
        print(f"profiling to {profile_dir}", file=sys.stderr)

    # Particle trajectory dump for the offline phase-space replay
    # (pypic_vpython.py:14 format: "x,v" rows, fixed particles per frame).
    dump_path = os.path.join(outdir, "particle_output.txt")
    if args.dump_particles and os.path.exists(dump_path):
        os.unlink(dump_path)  # frames append per span; never mix runs

    def _dump_frame(st):
        if not args.dump_particles:
            return
        k = args.dump_particles
        x = np.asarray(st.p)[:k] * preset.config.grid.dx
        v = np.asarray(st.v)
        v = (v[:, 0] if v.ndim == 2 else v)[:k]
        with open(dump_path, "a") as f:
            np.savetxt(f, np.stack([x, v], axis=-1), delimiter=",")

    # chunk the scan when periodic checkpoints or particle dumps need the
    # state on host mid-run (reference cadences: checkpoint every 100 steps,
    # pygcpic.py:1627-1632; per-frame particle writes, pygcpic.py:1440-1447)
    span_size = 0
    if mgr is not None:
        # cadences are in SIM steps; spans count step() calls (each one
        # advances spc sim steps under --migrate-every)
        ck_span = -(-mgr.every // spc)
        if spc > 1 and mgr.every % spc:
            print(f"checkpoint cadence rounded up to {ck_span * spc} "
                  f"(multiple of --migrate-every {spc})", file=sys.stderr)
        if args.steps > ck_span:
            span_size = ck_span
    if args.dump_particles and args.dump_every:
        # dump cadence is in SIM steps too (one frame per span boundary)
        dump_span = -(-args.dump_every // spc)
        if spc > 1 and args.dump_every % spc:
            print(f"dump cadence rounded up to {dump_span * spc} "
                  f"(multiple of --migrate-every {spc})", file=sys.stderr)
        if span_size and span_size != dump_span:
            print("dump-every follows checkpoint chunking cadence "
                  f"({span_size * spc})", file=sys.stderr)
        elif not span_size and dump_span <= args.steps:
            span_size = dump_span

    t0 = time.time()
    if span_size:
        # Thinning must be uniform across every chunk or the metric rows
        # would mix cadences — disable it (with a warning) unless every
        # span is divisible by plot_every.
        spans = []
        left = args.steps
        while left > 0:
            spans.append(min(span_size, left))
            left -= spans[-1]
        thin = bool(args.plot_every) and all(
            s % args.plot_every == 0 for s in spans
        )
        if args.plot_every and not thin:
            print("plot-every incompatible with chunking "
                  "(span not divisible); keeping full-cadence metrics",
                  file=sys.stderr)
        final = state
        chunks = []
        done = 0
        for span in spans:
            final, m = _run_span(final, span, thin)
            chunks.append(m)
            done += span
            if mgr is not None:
                mgr.maybe_save(final, done * spc)
            _dump_frame(final)
        metrics = jax.tree.map(lambda *xs: np.concatenate(xs), *chunks)
    else:
        thin = bool(args.plot_every) and args.steps % args.plot_every == 0
        final, metrics = _run_span(state, args.steps, thin)
        _dump_frame(final)
    jax.block_until_ready(jax.tree.leaves(metrics)[0])
    if spc > 1:
        # (calls, spc, ...) -> (sim_steps, ...): per-micro-step rows in order
        metrics = jax.tree.map(
            lambda a: np.asarray(a).reshape(-1, *np.shape(a)[2:]), metrics
        )
    if mgr is not None:
        mgr.close()  # drain any in-flight async checkpoint write
    if args.profile:
        jax.profiler.stop_trace()
    elapsed = time.time() - t0
    # wall-clock timing file (run_pypic.py:16-17)
    with open(os.path.join(outdir, "time.out"), "w") as f:
        print(elapsed, file=f)
    n = preset.state.p.shape[0]
    sim_steps = args.steps * spc
    print(f"{sim_steps} steps x {n} particles in {elapsed:.1f}s "
          f"({n * sim_steps / elapsed:.3g} pushes/s)", file=sys.stderr)

    if mgr is not None:
        checkpoint.save(
            os.path.join(outdir, "checkpoints", "final.npz"), final,
            step=sim_steps,
        )

    # metric dump as npz + JSONL scalars
    mdict = metrics._asdict() if hasattr(metrics, "_asdict") else dict(metrics)
    np.savez(os.path.join(outdir, "metrics.npz"),
             **{k: np.asarray(v) for k, v in mdict.items()})
    with open(os.path.join(outdir, "metrics.jsonl"), "w") as f:
        num = len(np.asarray(next(iter(mdict.values()))))
        for i in range(num):
            row = {}
            for k, v in mdict.items():
                arr = np.asarray(v)
                if arr.ndim == 1:
                    row[k] = float(arr[i])
            print(json.dumps(row), file=f)

    # text dumps (pypic.py:637-648) for engines exposing the fields
    if "field_energy" in mdict:
        params = preset.meta.get("params")
        meta_params = {}
        if params is not None:
            meta_params = dict(wp=params.wp, G=params.growth_rate,
                               tau=1.0 / params.wp, p2c=params.p2c)
        meta_params.update(dt=preset.config.dt, Ng=preset.config.grid.ng,
                           L=preset.config.grid.length)
        current = mdict.get("current_bias", np.zeros(1))
        diagnostics.write_run_outputs(
            outdir, mdict["field_energy"], np.asarray(current), meta_params
        )

    # pic_iead end-of-run surface post-process (pygcpic.py:1296-1305):
    # accumulated IEADs through the BCA, budget printed + written as JSON
    if args.bca_postprocess and hasattr(final, "iead"):
        from . import bca as bca_mod

        # incident species per IEAD row from the preset (default: pic_iead's
        # D and B, pygcpic.py:1147-1180)
        (m_src, z_src), (m_wall, z_wall) = preset.meta.get(
            "bca_incident", ((2.0, 1), (10.81, 5))
        )
        stats = bca_mod.postprocess_iead(
            np.asarray(final.iead),
            preset.config.iead_energy_max, preset.config.iead_angle_max,
            bca_mod.BinaryCollisionModel(incident_m_amu=m_src,
                                         incident_z=z_src),
            bca_mod.BinaryCollisionModel(incident_m_amu=m_wall,
                                         incident_z=z_wall),
        )
        print(  # the reference's budget line (pygcpic.py:1305)
            f"num_deposited: {stats['num_deposited_wall']:.0f}, "
            f"num_sputtered: {stats['num_sputtered']}, "
            f"{stats['num_reflected_wall']}, "
            f"{stats['num_incident_wall']:.0f}", file=sys.stderr)
        with open(os.path.join(outdir, "bca_postprocess.json"), "w") as f:
            json.dump({k: v for k, v in stats.items()
                       if np.isscalar(v)}, f, indent=1)

    # phase-space gif from the per-span particle dump (run_pypic.py:19-21's
    # gif assembly / pypic_vpython.py replay, as one offline post-process)
    if args.gif:
        if not (args.dump_particles and os.path.exists(dump_path)):
            print("--gif needs --dump-particles frames; skipping",
                  file=sys.stderr)
        else:
            from . import viz  # matplotlib + imageio: only when plotting

            xs, vs = viz.load_particle_dump(dump_path, args.dump_particles)
            gif_path = os.path.join(outdir, "phase_space.gif")
            viz.phase_space_replay(gif_path, xs, vs)
            print(f"wrote {gif_path}", file=sys.stderr)

    # IEAD heatmap + BCA run dashboard for the magnetized states — the
    # offline equivalents of pic_iead's live pcolormesh figures
    # (pygcpic.py:1283-1298) and the pic_bca_aps 8-figure dashboard
    # (pygcpic.py:1634-1702)
    if (args.plot and hasattr(final, "iead")
            and preset.config.iead_energy_max > 0):
        from . import viz

        cfg = preset.config
        labels = preset.meta.get("species_labels") or [
            f"Z{z}" for z in cfg.species_z
        ]
        viz.iead_figure(
            os.path.join(outdir, "iead.png"), np.asarray(final.iead),
            cfg.iead_energy_max, cfg.iead_angle_max, labels,
        )
        wrote = [f"{outdir}/iead.png"]
        # the full dashboard needs the escape histograms + rho leaves the
        # slab-sharded state doesn't carry (DomainMagnetizedState has no
        # iead_out) — domain runs still get the IEAD heatmap above
        if hasattr(final, "iead_out"):
            act = np.asarray(final.active) == 1
            xp = np.asarray(final.p)[act] * cfg.grid.dx
            vxp = np.asarray(final.vx)[act]
            rho = np.asarray(mdict["rho"])[-1]
            viz.bca_figure(
                os.path.join(outdir, "bca_dashboard.png"), xp, vxp,
                np.sqrt(vxp.var()) + 1e-300, np.asarray(final.phi), rho,
                np.asarray(final.iead), np.asarray(final.iead_out),
                cfg.iead_energy_max, cfg.iead_angle_max, cfg.grid.length,
                labels,
            )
            wrote.append(f"{outdir}/bca_dashboard.png")
        print(f"wrote {' + '.join(wrote)}", file=sys.stderr)

    # summary plot for the periodic engines
    if args.plot and hasattr(final, "v") and np.asarray(final.v).ndim == 1:
        from . import viz

        params = preset.meta.get("params")
        xp = np.asarray(final.p)
        vp = np.asarray(final.v)
        if hasattr(final, "alive"):  # domain states: drop dead slots
            keep = np.asarray(final.alive)
            xp, vp = xp[keep], vp[keep]
        vth = np.sqrt(vp.var()) + 1e-300
        # scalar metrics are full-cadence even under --plot-every thinning
        # (run_thinned thins only heavy array rows)
        times = np.arange(len(np.asarray(mdict["field_energy"]))) * (
            preset.config.dt
        )
        viz.summary_figure(
            os.path.join(outdir, "summary.png"),
            xp * preset.config.grid.dx,
            vp, vth,
            mdict["field_energy"], times,
            params.wp if params else 1.0,
            params.growth_rate if params else None,
            np.asarray(final.e), np.asarray(final.j),
            preset.config.grid.length,
            system=preset.meta.get("system", preset.name),
        )
        print(f"wrote {outdir}/summary.png", file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pypic_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    lp = sub.add_parser("list", help="list available presets")
    lp.set_defaults(fn=_cmd_list)

    rp = sub.add_parser("run", help="run a preset")
    rp.add_argument("preset")
    rp.add_argument("--steps", type=int, default=100)
    rp.add_argument("--particles", type=int, default=None)
    rp.add_argument("--shards", type=int, default=None,
                    help="device-mesh shards for the domain-decomposed "
                         "presets (default: all visible devices / "
                         "--replicas)")
    rp.add_argument("--replicas", type=int, default=None,
                    help="data-parallel replicas composed with the slab "
                         "axis (2D slabs x dp mesh) for the domain presets")
    rp.add_argument("--migrate-every", type=int, default=1,
                    help="domain_implicit: amortize particle migration "
                         "over this many micro-steps per superstep (halo "
                         "scales to cover the k-step excursion; --steps "
                         "rounds up to a multiple)")
    rp.add_argument("--opt", action="append", metavar="KEY=VALUE",
                    help="extra preset keyword, repeatable (e.g. --opt "
                         "field_solve=distributed); "
                         "ints/floats auto-coerced, '-' mapped to '_'")
    rp.add_argument("--outdir", default="plots")
    rp.add_argument("--plot-every", type=int, default=0,
                    help="thin metrics to every k steps (reference nplot)")
    rp.add_argument("--plot", action="store_true", help="write summary.png")
    rp.add_argument("--gif", action="store_true",
                    help="assemble a phase-space gif from the particle dump "
                         "frames (needs --dump-particles/--dump-every; "
                         "run_pypic.py:19-21 gif assembly as offline "
                         "post-process)")
    rp.add_argument("--checkpoint-every", type=int, default=0)
    rp.add_argument("--async-checkpoint", action="store_true",
                    help="write checkpoints on a background thread (the "
                         "step loop only pays the device-to-host copy; "
                         "atomicity and bit-exact resume unchanged)")
    rp.add_argument("--resume", action="store_true")
    rp.add_argument("--clean", action="store_true",
                    help="clear outdir first (run_pypic.py:8-10)")
    rp.add_argument("--profile", action="store_true",
                    help="write a jax.profiler trace to outdir/profile")
    rp.add_argument("--dump-particles", type=int, default=0,
                    help="append (x, v) rows for the first K particles to "
                         "particle_output.txt for the phase-space replay "
                         "(pypic_vpython.py format)")
    rp.add_argument("--dump-every", type=int, default=0,
                    help="particle-dump cadence in steps (chunks the run)")
    rp.add_argument("--bca-postprocess", action="store_true",
                    help="feed the end-of-run IEADs through the surface "
                         "model (pic_iead post-process, pygcpic.py:1299-1305)")
    rp.set_defaults(fn=_cmd_run)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
