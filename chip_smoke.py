#!/usr/bin/env python
"""Proof that pypic_tpu runs on an NVIDIA GPU, through its normal entry points.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the slab-decomposed phase only

Phases (one JAX process drives the card; each phase that fails ends the
script with a non-zero exit):

1. device — the first JAX device must be a GPU; prints its kind and count,
   the JAX version, nvidia-smi's name and power limit, and the compile cache.
2. compile — the Triton Picard pass and the headline implicit step at
   n = 1e8, ng = 200, compiled for the card; the step's memory analysis.
3. kernel — the Triton pass against the XLA pass, and both against a
   float64 evaluation of the same pass, at n = 1e7 and ng in {50, 200, 800}.
4. main path — the CLI's ``landau_damping`` run with its damping-rate
   check, then the 1e8-particle conserving headline for a few hundred steps
   (ms/step, mean Picard iterations, total-energy change over the window).
5. timing — the headline step with the XLA pass and with the Triton pass,
   in turns (xla, triton, triton, xla), plus the XLA pass with the matmul
   deposit.
6. presets — every other single-device preset a few steps through the CLI,
   each finishing with finite metrics.

The last line of standard output is the JSON result
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``;
nothing is printed there when a phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")

HEADLINE_N = 100_000_000
HEADLINE_NG = 200
# Tolerances of the kernel phase. Positions: the half-step position is a
# handful of float32 operations on values below ng, so two evaluations agree
# to a few units in the last place of ng. Currents: each node sums ~n/ng
# float32 terms of both signs, in no fixed order under atomics; relative to
# the largest node value the rounding stays far below 1e-4.
PH_ULPS = 4
JH_REL = 1e-4
# Landau preset: the early damping rate of the field-energy envelope (peaks
# before 10/wp) of the same preset on the CPU, float32, XLA pass, n = 1e6,
# seed 1, is -4228.3 1/s. The card must agree to 10% (the same fit at
# n = 1e5 moved by 3%).
LANDAU_REF_RATE = -4228.3
LANDAU_REL = 0.10
# The north star's energy bound is 1e-3 per 1e4 steps; no shorter window of
# the conserving run may exceed it.
ENERGY_BOUND = 1e-3
OTHER_PRESETS = ("two_stream", "bump_on_tail", "explicit_landau",
                 "sheath_dd", "pic_iead", "pic_iead_gc",
                 "dirichlet_neumann_test", "pic_bca_aps")


class PhaseFailed(RuntimeError):
    """A phase's result fell outside its stated limit."""


def _check(ok: bool, what: str):
    print(f"  check: {what}: {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise PhaseFailed(what)


def phase_device(require_gpu: bool = True):
    """Phase 1. Returns {"platform", "kind", "count"} of JAX's devices."""
    import jax

    from pypic_tpu import platform

    cache = platform.compile_cache()
    d = jax.devices()[0]
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}
    print(f"[device] {info} jax {jax.__version__}", flush=True)
    print(f"[device] compile cache: {cache}", flush=True)
    gpu = platform.gpu_name_and_power_limit()
    print(gpu if gpu is not None else "nvidia-smi: no NVIDIA GPU", flush=True)
    if require_gpu and d.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {d.platform!r}")
    return info


def headline(n: int, impl: str = "auto", **cfg_kw):
    """The bench headline problem in the conserving configuration."""
    from bench import CONSERVING, landau_problem
    from pypic_tpu.constants import E_CHARGE, M_ELECTRON
    from pypic_tpu.engines import implicit

    kw = dict(CONSERVING, picard_impl=impl)
    kw.update(cfg_kw)
    _, x, v, cfg = landau_problem(n, **kw)
    return cfg, implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)


def phase_compile(n: int, ng: int, impl: str = "triton"):
    """Phase 2. Compiles the pass and the headline step at (n, ng)."""
    import jax
    import jax.numpy as jnp

    from pypic_tpu.engines import implicit
    from pypic_tpu.ops.picard import picard_pass

    t0 = time.perf_counter()
    sd = jax.ShapeDtypeStruct
    parts = [sd((n,), jnp.float32)] * 3
    jax.jit(lambda f, ps, p0, v0: picard_pass(
        f, ps, p0, v0, ng, qm=-1.0, w=1.0, dt=1e-5, dx=1.0, impl=impl,
    )).lower(sd((ng,), jnp.float32), *parts).compile()
    cfg, state = headline(n, impl)
    compiled = jax.jit(implicit.make_step(cfg)).lower(state).compile()
    print(f"[compile] pass + step ({impl}, n={n:.3g}, ng={cfg.grid.ng}) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    print(f"[compile] step memory: {compiled.memory_analysis()}", flush=True)
    return cfg, state


def _pass_inputs(n, ng, seed=0):
    import jax
    import jax.numpy as jnp

    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    p0 = jax.random.uniform(k[0], (n,), jnp.float32, 0.0, ng)
    ps = jnp.mod(p0 + 0.05 * jax.random.normal(k[1], (n,), jnp.float32), ng)
    v0 = jax.random.normal(k[2], (n,), jnp.float32)
    field = jax.random.normal(k[3], (ng,), jnp.float32)
    return field, ps, p0, v0


def phase_kernel(n: int, ngs=(50, 200, 800), interpret: bool = False):
    """Phase 3. Triton pass vs XLA pass vs float64, per ng; returns the
    worst errors. Passes run with emit_v, so v1 is compared as well."""
    import jax
    import jax.numpy as jnp

    from pypic_tpu.ops.picard import picard_pass

    kw = dict(qm=-0.3, w=1e-3, dt=0.1, dx=1.0, emit_v=True)
    worst = {}
    for ng in ngs:
        args = _pass_inputs(n, ng)
        xla = jax.jit(lambda *a, ng=ng: picard_pass(*a, ng, impl="xla", **kw))
        tri = jax.jit(lambda *a, ng=ng: picard_pass(
            *a, ng, impl="triton", interpret=interpret, **kw))
        outs = {"xla": xla(*args), "triton": tri(*args)}
        with jax.enable_x64(True):
            a64 = [jnp.asarray(np.asarray(a), jnp.float64) for a in args]
            ref = [np.asarray(o) for o in picard_pass(
                *a64, ng, impl="xla", **kw)]
        ph_lim = PH_ULPS * float(np.spacing(np.float32(ng)))
        jscale = np.abs(ref[2]).max()
        errs = {}
        for name, o in outs.items():
            o = [np.asarray(a, np.float64) for a in o]
            against = {"f64": ref}
            if name == "triton":
                against["xla"] = [np.asarray(a, np.float64)
                                  for a in outs["xla"]]
            for rname, r in against.items():
                # wrapped positions: compare on the circle
                dph = np.abs(o[0] - r[0])
                dph = np.minimum(dph, ng - dph).max()
                dv = np.abs(o[1] - r[1]).max() / np.abs(r[1]).max()
                djh = np.abs(o[2] - r[2]).max() / jscale
                key = f"{name} vs {rname}"
                errs[key] = (dph, dv, djh)
                print(f"[kernel] ng={ng} {key}: max|dph| {dph:.3e} "
                      f"(limit {ph_lim:.3e}), rel|dv1| {dv:.3e} "
                      f"(limit {JH_REL:.0e}), rel|djh| {djh:.3e} "
                      f"(limit {JH_REL:.0e})", flush=True)
                _check(dph <= ph_lim and dv <= JH_REL and djh <= JH_REL,
                       f"ng={ng} {key} within limits")
        worst[ng] = errs
    print("[kernel] precision: float32 passes, float64 reference "
          "(jax.enable_x64); no matrix product in the pass",
          flush=True)
    return worst


def run_cli(preset: str, steps: int, *extra: str, outdir: str = OUT):
    """One preset through the command-line entry point, in this process.
    Returns the metrics it wrote under ``outdir/preset``."""
    from pypic_tpu.cli import main as cli_main

    out = os.path.join(outdir, preset)
    cli_main(["run", preset, "--steps", str(steps), "--outdir", out,
              "--clean", *extra])
    with np.load(os.path.join(out, "metrics.npz")) as f:
        return {k: f[k] for k in f.files}


def landau_cli(n: int | None, steps: int, outdir: str = OUT):
    """Phase 4a. The CLI's landau_damping run; returns the early damping
    rate of its field-energy envelope (peaks before 10/wp)."""
    from pypic_tpu import diagnostics, presets

    extra = ("--particles", str(n)) if n else ()
    m = run_cli("landau_damping", steps, *extra, outdir=outdir)
    wp = presets.landau_damping(n=64).meta["params"].wp
    dt = 1e-5  # the preset's step (pypic.py:846-855)
    return diagnostics.damping_rate_from_peaks(
        m["field_energy"], dt, t_max=10.0 / wp)


def _timed_run(step, state, steps):
    """(ms per step, metrics) of one compiled scan of ``steps`` steps,
    after a warm-up run of the same length."""
    import jax

    from pypic_tpu.runner import run

    jax.block_until_ready(run(step, state, steps))
    t0 = time.perf_counter()
    _, m = jax.block_until_ready(run(step, state, steps))
    return (time.perf_counter() - t0) / steps * 1e3, m


def phase_headline(n: int, steps: int, impl: str = "auto"):
    """Phase 4b. The conserving headline for ``steps`` steps. Returns
    (ms/step, mean Picard iterations, relative total-energy change)."""
    from pypic_tpu.engines import implicit

    cfg, state = headline(n, impl)
    ms, m = _timed_run(implicit.make_step(cfg), state, steps)
    tot = (np.asarray(m.field_energy, np.float64)
           + np.asarray(m.kinetic_energy, np.float64))
    de = float((tot[-1] - tot[0]) / tot[0])
    iters = float(np.asarray(m.picard_iters).mean())
    print(f"[headline] n={n:.3g} ng={cfg.grid.ng} {steps} steps: "
          f"{ms:.3f} ms/step, mean Picard iterations {iters:.2f}, "
          f"relative total-energy change {de:+.3e} (bound {ENERGY_BOUND:g})",
          flush=True)
    _check(np.isfinite(de) and abs(de) < ENERGY_BOUND,
           "headline energy change within bound")
    return ms, iters, de


def phase_timing(n: int, steps: int, order=("xla", "triton", "triton", "xla")):
    """Phase 5. ms/step of the headline step per implementation, in turns,
    plus the XLA pass with the matmul deposit. Returns {label: [ms, ...]}."""
    from pypic_tpu.engines import implicit

    times: dict[str, list[float]] = {}
    runs = [(impl, impl, {}) for impl in order]
    runs.append(("xla+matmul", "xla", {"deposit_method": "matmul"}))
    for label, impl, kw in runs:
        cfg, state = headline(n, impl, **kw)
        ms, _ = _timed_run(implicit.make_step(cfg), state, steps)
        times.setdefault(label, []).append(ms)
        print(f"[timing] {label}: {ms:.3f} ms/step", flush=True)
    return times


def phase_presets(names=OTHER_PRESETS, steps: int = 5, outdir: str = OUT):
    """Phase 6. Each preset a few steps through the CLI; every float metric
    it wrote must be finite."""
    for name in names:
        m = run_cli(name, steps, outdir=outdir)
        bad = [k for k, a in m.items()
               if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all()]
        energies = {k: float(np.asarray(m[k])[-1]) for k in
                    ("field_energy", "kinetic_energy") if k in m}
        print(f"[presets] {name}: {steps} steps, last {energies or 'metrics'}"
              f"{'' if not bad else f', non-finite {bad}'}", flush=True)
        _check(not bad, f"{name} metrics finite")


def phase_four(n: int, steps: int, cli_steps: int = 5, outdir: str = OUT):
    """Four GPUs: domain_implicit at 4 shards against 1 shard, then
    domain_explicit and pic_iead_dd at 4 shards through the CLI."""
    import jax

    from pypic_tpu import presets
    from pypic_tpu.runner import run

    if len(jax.devices()) < 4:
        raise SystemExit(f"chip_smoke --four: needs 4 devices, found "
                         f"{len(jax.devices())}")
    res = {}
    # 4 shards first: the per-device peaks then show where that run's
    # particles sat, before the 1-shard run loads device 0 alone
    for shards in (4, 1):
        pre = presets.domain_implicit(n=n, shards=shards)
        t0 = time.perf_counter()
        _, m = jax.block_until_ready(run(pre.make_step(), pre.state, steps))
        res[shards] = m
        print(f"[four] domain_implicit n={n:.3g} shards={shards}: {steps} "
              f"steps in {time.perf_counter() - t0:.1f}s (compile "
              f"included); n_alive {int(m.n_alive[-1])}, migrated "
              f"{int(np.sum(m.n_migrated))}, dropped "
              f"{int(np.sum(m.n_dropped))}, halo clamped "
              f"{int(np.sum(m.n_halo_clamped))}", flush=True)
        if shards == 4:
            for d in jax.devices()[:4]:
                peak = (d.memory_stats() or {}).get("peak_bytes_in_use")
                print(f"[four] {d} after the 4-shard run: peak_bytes_in_use "
                      f"{'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}",
                      flush=True)
        del pre
    m1, m4 = res[1], res[4]
    for key in ("field_energy", "kinetic_energy"):
        a1 = np.asarray(getattr(m1, key), np.float64)
        a4 = np.asarray(getattr(m4, key), np.float64)
        rel = float(np.abs(a4 - a1).max() / np.abs(a1).max())
        print(f"[four] {key} 4 vs 1 shards over {steps} steps: max rel "
              f"diff {rel:.3e} (limit 1e-3)", flush=True)
        _check(rel < 1e-3, f"{key} 4-shard agrees with 1-shard")
    _check(int(m4.n_alive[-1]) == n and int(np.sum(m4.n_dropped)) == 0,
           "4-shard run keeps every particle")
    _check(int(np.sum(m4.n_migrated)) > 0,
           "4-shard run migrates particles between slabs")
    for name in ("domain_explicit", "pic_iead_dd"):
        m = run_cli(name, cli_steps, "--shards", "4", outdir=outdir)
        bad = [k for k, a in m.items()
               if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all()]
        print(f"[four] {name} at 4 shards: {cli_steps} steps", flush=True)
        _check(not bad, f"{name} metrics finite")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU slab-decomposed phase")
    args = ap.parse_args(argv)
    info = phase_device()
    os.makedirs(OUT, exist_ok=True)
    if args.four:
        phase_four(HEADLINE_N, steps=10)
    else:
        phase_compile(HEADLINE_N, HEADLINE_NG)
        phase_kernel(10_000_000)
        rate = landau_cli(None, 200)
        print(f"[landau] CLI landau_damping damping rate {rate:.1f} 1/s, "
              f"reference {LANDAU_REF_RATE} 1/s (limit {LANDAU_REL:.0%})",
              flush=True)
        _check(abs(rate / LANDAU_REF_RATE - 1.0) < LANDAU_REL,
               "landau_damping damping rate")
        phase_headline(HEADLINE_N, 300)
        times = phase_timing(HEADLINE_N, 10)
        med = {k: float(np.median(v)) for k, v in times.items()}
        print(f"[timing] median ms/step {med}; faster: "
              f"{min(med, key=med.get)}", flush=True)
        phase_presets()
    from pypic_tpu import platform

    print(platform.gpu_name_and_power_limit())
    print(json.dumps({"ok": True, "device": info}))


if __name__ == "__main__":
    try:
        main()
    except PhaseFailed as e:
        print(f"chip_smoke: phase failed: {e}", file=sys.stderr)
        sys.exit(1)
