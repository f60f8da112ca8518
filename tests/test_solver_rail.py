"""Outer-Krylov fallback + convergence rail (VERDICT r1 #7, #8).

- FGMRES (solvers/gmres.py) solves the same systems PCG does, to the
  same tolerance (the reference's own outer method,
  LinearElasticity.cc:638-650).
- The driver warns loudly when the solver hits maxiter without reaching
  rtol and records it in the history ('stalled').
- The fused step now carries the reference's first-iteration semantics
  (fscale at itr 1, fresh asymptotes at itr <= 2), so fused trajectories
  match the interactive Driver's exactly from iteration 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from topopt_in_petsc_tpu.config import TopOptConfig
from topopt_in_petsc_tpu.grid import Grid
from topopt_in_petsc_tpu.models.elements import hex8_stiffness
from topopt_in_petsc_tpu.ops.hex_operator import (
    apply_hex_operator,
    assemble_dense,
)
from topopt_in_petsc_tpu.solvers.cg import pcg
from topopt_in_petsc_tpu.solvers.gmres import fgmres


@pytest.fixture(scope="module")
def small_system():
    grid = Grid(nn=(9, 5, 5), lo=(0, 0, 0), hi=(2, 1, 1))
    KE = hex8_stiffness(*grid.h, 0.3)
    rng = np.random.default_rng(0)
    scale = rng.uniform(1e-3, 1.0, size=grid.ne)
    A = lambda v: apply_hex_operator(
        v, jnp.asarray(scale), jnp.asarray(KE)
    ) + 0.1 * v  # shifted SPD (pure-Neumann K is singular)
    b = jnp.asarray(rng.normal(size=(*grid.nn, 3)))
    Kd = assemble_dense(scale, KE, grid.nn, dof=3)
    Kd = Kd + 0.1 * np.eye(Kd.shape[0])
    x_exact = np.linalg.solve(Kd, np.asarray(b).ravel())
    return A, b, x_exact


def test_fgmres_matches_dense_solution(small_system):
    A, b, x_exact = small_system
    res = fgmres(
        A, b, jnp.zeros_like(b), rtol=1e-10, maxiter=500, restart=30
    )
    assert float(res.relres) < 1e-10
    np.testing.assert_allclose(
        np.asarray(res.x).ravel(), x_exact, rtol=1e-7
    )


def test_fgmres_agrees_with_pcg(small_system):
    A, b, x_exact = small_system
    r1 = pcg(A, b, jnp.zeros_like(b), rtol=1e-9, maxiter=500)
    r2 = fgmres(
        A, b, jnp.zeros_like(b), rtol=1e-9, maxiter=500, restart=25
    )
    np.testing.assert_allclose(
        np.asarray(r1.x), np.asarray(r2.x), atol=1e-7
    )


def test_fgmres_with_jacobi_preconditioner(small_system):
    A, b, x_exact = small_system
    dinv = 1.0 / jnp.asarray(
        np.diag(
            assemble_dense(
                np.ones((8, 4, 4)), hex8_stiffness(0.25, 0.25, 0.25, 0.3),
                (9, 5, 5), dof=3,
            )
        ).reshape(9, 5, 5, 3)
        + 0.1
    )
    M = lambda r: dinv * r
    res = fgmres(
        A, b, jnp.zeros_like(b), M, rtol=1e-9, maxiter=400, restart=20
    )
    np.testing.assert_allclose(
        np.asarray(res.x).ravel(), x_exact, rtol=1e-6
    )


def test_fgmres_respects_maxiter(small_system):
    A, b, _ = small_system
    res = fgmres(
        A, b, jnp.zeros_like(b), rtol=1e-14, maxiter=7, restart=5
    )
    assert int(res.iters) == 7
    assert float(res.relres) > 1e-14


def test_fgmres_nonzero_initial_guess(small_system):
    A, b, x_exact = small_system
    x0 = jnp.asarray(x_exact.reshape(b.shape)) * 0.999
    res = fgmres(A, b, x0, rtol=1e-10, maxiter=200, restart=10)
    cold = fgmres(
        A, b, jnp.zeros_like(b), rtol=1e-10, maxiter=200, restart=10
    )
    # warm start must converge and beat the cold start
    assert float(res.relres) < 1e-10
    assert int(res.iters) < int(cold.iters)
    np.testing.assert_allclose(
        np.asarray(res.x).ravel(), x_exact, rtol=1e-6
    )


def test_cli_ksp_type_fgmres_runs():
    """Full driver run with -ksp_type fgmres: trajectory close to FCG."""
    from topopt_in_petsc_tpu.driver import Driver

    base = dict(
        nx=9, ny=5, nz=5, nlvls=2, rmin=0.16, dtype="float64",
        maxItr=3, restart=False, output_cadence_vtu=False,
        workdir="/tmp/topopt_fgmres_test",
    )
    h_cg = Driver(TopOptConfig(**base, ksp_type="fcg")).run()
    h_gm = Driver(TopOptConfig(**base, ksp_type="fgmres")).run()
    np.testing.assert_allclose(h_cg["fx"], h_gm["fx"], rtol=1e-4)
    assert not any(h_gm["stalled"])


def test_stall_warning_and_history_flag(capsys):
    """maxiter too small to converge -> loud warning + history flag."""
    from topopt_in_petsc_tpu.driver import Driver

    cfg = TopOptConfig(
        nx=9, ny=5, nz=5, nlvls=2, rmin=0.16, dtype="float64",
        maxItr=1, ksp_maxit=2, restart=False,
        output_cadence_vtu=False, workdir="/tmp/topopt_stall_test",
    )
    h = Driver(cfg).run()
    out = capsys.readouterr().out
    assert "DID NOT CONVERGE" in out
    assert h["stalled"] == [True]


def test_ksp_type_validation():
    with pytest.raises(ValueError, match="ksp_type"):
        TopOptConfig(ksp_type="bogus").validate()


def test_fused_step_matches_driver_from_iteration_one(tmp_path):
    """The fused step's first-iteration semantics (fscale, fresh
    asymptotes) make its trajectory IDENTICAL to the Driver's."""
    import jax

    from topopt_in_petsc_tpu.driver import Driver
    from topopt_in_petsc_tpu.parallel.fused_step import make_fused_step

    kw = dict(
        nx=9, ny=5, nz=5, nlvls=2, rmin=0.16, dtype="float64",
        restart=False, output_cadence_vtu=False,
        workdir=str(tmp_path),
    )
    hist = Driver(TopOptConfig(**kw)).run(max_iters=4)

    step, state = make_fused_step(TopOptConfig(**kw))
    fx_fused = []
    for itr in range(1, 5):
        state = step(state, itr)
        fx_fused.append(float(state.fx))
    np.testing.assert_allclose(hist["fx"], fx_fused, rtol=1e-10)
    assert float(state.fscale) == pytest.approx(
        10.0 / hist["fx"][0], rel=1e-12
    )
