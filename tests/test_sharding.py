"""Multi-device sharding tests on the 8-device CPU mesh (SURVEY §4(g)).

Validates that the sharded execution path — GSPMD-partitioned hex operator,
multigrid, filters and MMA — produces the same numbers as single-device
execution, and that the fused step compiles and runs over a real
('x','y','z') mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topopt_in_petsc_tpu.config import TopOptConfig
from topopt_in_petsc_tpu.grid import Grid
from topopt_in_petsc_tpu.models.elasticity import LinearElasticity
from topopt_in_petsc_tpu.models.elements import hex8_stiffness
from topopt_in_petsc_tpu.ops.hex_operator import apply_hex_operator
from topopt_in_petsc_tpu.parallel.fused_step import make_fused_step
from topopt_in_petsc_tpu.parallel.mesh import (
    elem_sharding,
    make_device_mesh,
    node_sharding,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def test_sharded_operator_matches_single_device():
    grid = Grid(nn=(17, 9, 9), lo=(0, 0, 0), hi=(2, 1, 1))
    KE = jnp.asarray(hex8_stiffness(*grid.h, 0.3))
    rng = np.random.default_rng(0)
    scale = jnp.asarray(rng.uniform(0.2, 1.0, size=grid.ne))
    u = jnp.asarray(rng.normal(size=(*grid.nn, 3)))

    ref = apply_hex_operator(u, scale, KE)

    mesh = make_device_mesh((2, 2, 2))
    us = jax.device_put(u, node_sharding(mesh))
    ss = jax.device_put(scale, elem_sharding(mesh))
    f = jax.jit(lambda uu, sc: apply_hex_operator(uu, sc, KE))
    out = f(us, ss)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-12)


def test_sharded_physics_step_matches():
    """Full MG-PCG physics step: sharded == unsharded."""
    cfg = TopOptConfig(
        nx=17, ny=9, nz=9, nlvls=2, dtype="float64", rmin=0.16
    )
    cfg.validate()
    phys = LinearElasticity(cfg)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.uniform(0.3, 0.9, size=phys.grid.ne))
    # the warm-start buffer is DONATED into the solution (memory saving
    # at 256^3+): pass a fresh buffer per call
    ref = phys.compute_objective_constraints_sensitivities(
        x, jnp.zeros((*phys.grid.nn, 3))
    )

    mesh = make_device_mesh((2, 2, 2))
    xs = jax.device_put(x, elem_sharding(mesh))
    us = jax.device_put(
        jnp.zeros((*phys.grid.nn, 3)), node_sharding(mesh)
    )
    res = phys.compute_objective_constraints_sensitivities(xs, us)

    assert int(res.iters) == int(ref.iters)
    np.testing.assert_allclose(float(res.fx), float(ref.fx), rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(res.dfdx), np.asarray(ref.dfdx), rtol=1e-8
    )


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_dryrun_multichip(n_devices):
    import sys
    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(n_devices)


def test_fused_step_runs_and_iterates():
    cfg = TopOptConfig(
        nx=17, ny=9, nz=9, nlvls=2, rmin=0.16, dtype="float64"
    )
    cfg.validate()
    mesh = make_device_mesh((2, 2, 2))
    step, state = make_fused_step(cfg, mesh=mesh)
    s1 = step(state, 1)
    s2 = step(s1, 2)
    assert np.isfinite(float(s1.fx)) and np.isfinite(float(s2.fx))
    assert float(s2.fx) > 0.0  # compliance is positive
    assert float(jnp.max(jnp.abs(s2.x - s1.x))) > 0.0  # design moved
    assert float(s2.ch) <= 0.2 + 1e-9  # movelimit respected
