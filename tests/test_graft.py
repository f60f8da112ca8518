"""Guard the driver-harness entry points (they are compile-checked
externally; breaking their signatures must fail the suite first)."""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_entry_compiles_and_runs():
    from __graft_entry__ import entry

    fn, args = entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    fx = float(out[0])
    assert np.isfinite(fx) and fx > 0
