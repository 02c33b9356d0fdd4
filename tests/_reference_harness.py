"""Shared loader for the reference-golden test modules.

Imports the ACTUAL upstream sources from /root/reference (read-only) with
numba stubbed to identity — the reference kernels are plain numpy under
the decorator — and matplotlib forced onto Agg. Used by
test_reference_parity.py (deterministic paths) and
test_reference_parity_rng.py (RNG-driven lifecycle paths).
"""

import os
import sys
import types

import numpy as np
import pytest

REF = "/root/reference"


class AnySig:
    """Stands in for numba type objects: supports [:] and call chaining
    (nb.float64[:], nb.types.UniTuple(...)(...)) and always yields itself."""

    def __getitem__(self, item):
        return self

    def __call__(self, *args, **kwargs):
        return self


def jit_stub(*args, **kwargs):
    """numba.jit stub: both @jit and @jit(signature, **opts) forms return
    the undecorated function. Signature objects are AnySig instances or
    strings — never plain Python functions, so the isfunction test is an
    unambiguous discriminator."""
    import inspect

    if args and inspect.isfunction(args[0]):
        return args[0]

    def deco(fn):
        return fn

    return deco


def install_numba_stub():
    if "numba" in sys.modules and hasattr(sys.modules["numba"], "jit"):
        return
    nb = types.ModuleType("numba")
    nb.jit = jit_stub
    nb.njit = jit_stub
    nb.prange = range
    sig = AnySig()
    nb.float64 = sig
    nb.float32 = sig
    nb.int32 = sig
    nb.int64 = sig
    tmod = types.ModuleType("numba.types")
    tmod.UniTuple = sig
    nb.types = tmod
    sys.modules["numba"] = nb
    sys.modules["numba.types"] = tmod


def skip_without_reference():
    """Skip the calling test (from inside its fixture, never at import or
    collection) when the upstream sources are not on this machine."""
    if not os.path.isdir(REF):
        pytest.skip(f"reference pyPIC sources not found at {REF}; the "
                    "parity tests compare against them side by side")


def load_reference():
    """Import and return (pypic, pygcpic) from the reference sources
    (skips the calling test when they are absent)."""
    skip_without_reference()
    sys.dont_write_bytecode = True  # /root/reference is read-only
    install_numba_stub()
    import matplotlib

    matplotlib.use("Agg")
    sys.path.insert(0, REF)
    try:
        import pypic as ref_pypic
        import pygcpic as ref_pygcpic
    finally:
        sys.path.remove(REF)
        # pypic.py sets usetex at import; undo so unrelated viz tests
        # don't start requiring a TeX install
        matplotlib.rcParams["text.usetex"] = False
    # the reference targets an old scipy that re-exported numpy's diag as
    # scipy.diag (pypic.py:347); shim it on the module's OWN namespace only
    if not hasattr(ref_pypic.sp, "diag"):
        import scipy

        class _ScipyShim:
            diag = staticmethod(np.diag)

            def __getattr__(self, name):
                return getattr(scipy, name)

        ref_pypic.sp = _ScipyShim()
    return ref_pypic, ref_pygcpic


def load_pic_l_dd():
    """Import the gen-2 PIC_L_DD module (needs the numba stub)."""
    skip_without_reference()
    sys.dont_write_bytecode = True
    install_numba_stub()
    import matplotlib

    matplotlib.use("Agg")
    sys.path.insert(0, REF)
    try:
        import PIC_L_DD as ref_dd
    finally:
        sys.path.remove(REF)
    return ref_dd
