"""Checkpoint / resume: bit-exact state persistence.

The reference checkpoints by pickling the whole Python particle list and grid
object every 100 steps with no versioning or atomicity
(pygcpic.py:1627-1632, load at 1378-1383). Here any engine state pytree
(fixed-shape arrays + RNG key + step counter) round-trips bit-exactly through
a numpy ``.npz`` container with a JSON manifest, written atomically
(tmp + rename) so a crash mid-save never corrupts the latest checkpoint.

Resume is bit-exact: every leaf (including the PRNG key) restores to the
identical values, so a restarted run reproduces the original trajectory
exactly — the property test_checkpoint.py asserts.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import jax

_MANIFEST = "manifest.json"
# v2: leaves are stored with their pytree key paths so adding a state field
# to an engine never breaks restoring older checkpoints (new leaves fall back
# to the template's value); v1 matched leaves positionally.
_FORMAT_VERSION = 2


def _flatten_with_paths(state):
    kps, treedef = jax.tree_util.tree_flatten_with_path(state)
    paths = [jax.tree_util.keystr(kp) for kp, _ in kps]
    leaves = [leaf for _, leaf in kps]
    return paths, leaves, treedef


def _write_npz(path: str, paths, arrays, step, extra):
    """Atomic tmp+rename npz write of already-host-resident leaf arrays
    (the filesystem half of ``save`` — runs on the async writer thread)."""
    manifest = {
        "format_version": _FORMAT_VERSION,
        "num_leaves": len(arrays),
        "leaf_paths": paths,
        "step": int(step) if step is not None else None,
        "extra": extra or {},
    }
    named = {f"leaf_{i}": a for i, a in enumerate(arrays)}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __manifest__=json.dumps(manifest), **named)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save(path: str, state, step: int | None = None, extra: dict | None = None):
    """Atomically save a state pytree to ``path`` (an .npz file)."""
    paths, leaves, _ = _flatten_with_paths(state)
    _write_npz(path, paths, [np.asarray(leaf) for leaf in leaves], step,
               extra)


def load(path: str, template, migrate: dict | None = None):
    """Restore a state pytree saved with ``save``.

    Args:
        path: the .npz file.
        template: a pytree with the same structure (e.g. a freshly
            constructed initial state) providing the treedef and leaf dtypes.
        migrate: optional {old_leaf_path: fn(array) -> {new_path: array}}
            renames applied to checkpoint leaves the template no longer has
            (engines declare theirs as ``CHECKPOINT_MIGRATIONS``, e.g. the
            sheath state's round-3 ``.v`` -> ``.u``/``.vy``/``.vz`` split).

    Returns:
        (state, manifest_dict)
    """
    import sys

    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data["__manifest__"]))
        if manifest["format_version"] not in (1, _FORMAT_VERSION):
            raise ValueError(
                f"checkpoint format {manifest['format_version']} != "
                f"{_FORMAT_VERSION}"
            )
        paths, leaves, treedef = _flatten_with_paths(template)
        if manifest["format_version"] == 1 or "leaf_paths" not in manifest:
            # positional v1 layout: require an exact structural match
            if manifest["num_leaves"] != len(leaves):
                raise ValueError(
                    f"v1 checkpoint has {manifest['num_leaves']} leaves, "
                    f"template has {len(leaves)} — engine/state mismatch"
                )
            by_path = {p: data[f"leaf_{i}"] for i, p in enumerate(paths)}
        else:
            by_path = {
                p: data[f"leaf_{i}"]
                for i, p in enumerate(manifest["leaf_paths"])
            }
        if migrate:
            for old, fn in migrate.items():
                if old in by_path and old not in paths:
                    by_path.update(fn(by_path.pop(old)))
        # a checkpoint leaf the template does not know is a rename or a
        # wrong-engine template — refuse rather than silently mixing states
        unknown = sorted(set(by_path) - set(paths))
        if unknown:
            raise ValueError(
                f"checkpoint leaves {unknown} not in the template state "
                f"(paths: {paths}) — engine/state mismatch"
            )
        new_leaves = []
        for p, leaf in zip(paths, leaves):
            want = np.asarray(leaf)
            if p not in by_path:
                # a field added to the engine state after this checkpoint was
                # written: fall back to the template's (freshly initialized)
                # value so resume still works
                print(f"checkpoint: leaf {p} absent in {path}; using the "
                      "template value", file=sys.stderr)
                new_leaves.append(jax.numpy.asarray(want))
                continue
            arr = by_path[p]
            if arr.shape != want.shape or arr.dtype != want.dtype:
                raise ValueError(
                    f"leaf {p}: checkpoint {arr.shape}/{arr.dtype} vs "
                    f"template {want.shape}/{want.dtype}"
                )
            new_leaves.append(jax.numpy.asarray(arr))
    return jax.tree_util.tree_unflatten(treedef, new_leaves), manifest


class CheckpointManager:
    """Periodic checkpointing with the reference's cadence semantics
    (``checkpoint_saving=100``, pygcpic.py:1336)."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3,
                 prefix: str = "state", async_write: bool = False,
                 extra: dict | None = None):
        """``async_write=True`` moves the npz compression + filesystem write
        to a single background thread: ``maybe_save`` fetches the leaves to
        host (the only device-synchronous part — D2H copy) and returns, so
        the step loop resumes while the previous checkpoint is still being
        compressed. At most one write is in flight (the next save waits,
        preserving order and bounding the extra host memory to one state
        copy); writer errors surface on the NEXT save / ``wait()`` /
        ``restore``, never silently. Atomicity (tmp + rename) is unchanged,
        so a crash mid-write still never corrupts the previous checkpoint.
        The reference blocks its loop on a synchronous pickle instead
        (pygcpic.py:1627-1632). ``extra`` is stored verbatim in every
        manifest (run provenance)."""
        self.directory = directory
        self.extra = extra
        self.every = int(every)
        self.keep = int(keep)
        self.prefix = prefix
        self._last_saved = 0
        self._executor = None
        self._pending = None
        if async_write:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pypic-ckpt")
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{step:010d}.npz")

    def maybe_save(self, state, step: int) -> bool:
        """Save when ``step`` crosses an ``every`` boundary since the last
        save — correct both for per-step calls and for strided callers (e.g.
        the hybrid BCA driver advancing pic_steps_per_bca steps per call,
        where exact multiples may never be hit)."""
        if step // self.every <= self._last_saved // self.every:
            return False
        if self._executor is None:
            save(self._path(step), state, step=step, extra=self.extra)
            self._last_saved = step
            self._gc()
            return True
        # async: complete (and error-check) the previous write, snapshot the
        # leaves to host, hand compression + write + gc to the worker
        self.wait()
        paths, leaves, _ = _flatten_with_paths(state)
        arrays = [np.asarray(leaf) for leaf in leaves]
        path = self._path(step)

        def _task():
            _write_npz(path, paths, arrays, step, self.extra)
            self._gc()

        self._pending = self._executor.submit(_task)
        self._pending_prev_saved = self._last_saved
        self._last_saved = step
        return True

    def wait(self):
        """Block until the in-flight async write (if any) completes;
        re-raises any writer error. On failure the cadence rolls back so
        the failed window is retried at the next boundary rather than
        silently skipped."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            try:
                pending.result()
            except BaseException:
                self._last_saved = self._pending_prev_saved
                raise

    def close(self):
        """Drain the writer and shut it down (call at end of run)."""
        self.wait()
        if self._executor is not None:
            self._executor.shutdown(wait=True)

    def _gc(self):
        ckpts = sorted(self.steps())
        for s in ckpts[: -self.keep] if self.keep > 0 else []:
            os.unlink(self._path(s))

    def steps(self):
        out = []
        for f in os.listdir(self.directory):
            if f.startswith(self.prefix + "_") and f.endswith(".npz"):
                out.append(int(f[len(self.prefix) + 1 : -4]))
        return sorted(out)

    def latest(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None,
                migrate: dict | None = None):
        self.wait()  # a pending async write may be the checkpoint requested
        if step is None:
            step = self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return load(self._path(step), template, migrate=migrate)
