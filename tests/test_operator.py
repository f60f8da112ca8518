"""Matrix-free hex operator vs explicit dense assembly on tiny grids
(SURVEY §4(b))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topopt_in_petsc_tpu.grid import Grid
from topopt_in_petsc_tpu.models.elements import hex8_stiffness
from topopt_in_petsc_tpu.ops.hex_operator import (
    apply_hex_operator,
    assemble_dense,
    element_quadratic_form,
    gather_element_dofs,
    hex_operator_diagonal,
    scatter_element_dofs,
)

NN = (5, 4, 3)
NU = 0.3


@pytest.fixture(scope="module")
def setup():
    grid = Grid(nn=NN, lo=(0, 0, 0), hi=(1.0, 0.7, 0.5))
    KE = hex8_stiffness(*grid.h, NU)
    rng = np.random.default_rng(42)
    scale = rng.uniform(0.2, 1.0, size=grid.ne)
    u = rng.normal(size=(*NN, 3))
    return grid, KE, scale, u


def test_adjoint_gather_scatter(setup):
    grid, KE, scale, u = setup
    rng = np.random.default_rng(1)
    fe = rng.normal(size=(*grid.ne, 24))
    ue = gather_element_dofs(jnp.asarray(u))
    s = scatter_element_dofs(jnp.asarray(fe), NN)
    lhs = float(jnp.vdot(ue, fe))
    rhs = float(jnp.vdot(jnp.asarray(u), s))
    assert abs(lhs - rhs) < 1e-10 * abs(lhs)


def test_apply_matches_dense(setup):
    grid, KE, scale, u = setup
    Kd = assemble_dense(scale, KE, NN, dof=3)
    expected = (Kd @ u.ravel()).reshape(*NN, 3)
    got = apply_hex_operator(
        jnp.asarray(u), jnp.asarray(scale), jnp.asarray(KE)
    )
    np.testing.assert_allclose(np.asarray(got), expected, rtol=1e-10)


def test_diagonal_matches_dense(setup):
    grid, KE, scale, u = setup
    Kd = assemble_dense(scale, KE, NN, dof=3)
    got = hex_operator_diagonal(jnp.asarray(scale), jnp.asarray(KE), NN)
    np.testing.assert_allclose(
        np.asarray(got).ravel(), np.diag(Kd), rtol=1e-10
    )


def test_quadratic_form(setup):
    grid, KE, scale, u = setup
    Kd = assemble_dense(scale, KE, NN, dof=3)
    q = element_quadratic_form(jnp.asarray(u), jnp.asarray(KE))
    total = float(jnp.sum(jnp.asarray(scale) * q))
    expected = u.ravel() @ Kd @ u.ravel()
    assert abs(total - expected) < 1e-10 * abs(expected)


def test_scalar_dof_operator():
    """Same machinery with dof=1 (Helmholtz filter path)."""
    from topopt_in_petsc_tpu.models.elements import (
        helmholtz_element_matrices,
    )

    grid = Grid(nn=(4, 3, 5), lo=(0, 0, 0), hi=(0.6, 0.4, 0.8))
    KF, _ = helmholtz_element_matrices(*grid.h, R=0.05)
    rng = np.random.default_rng(7)
    u = rng.normal(size=(4, 3, 5, 1))
    scale = np.ones(grid.ne)
    Kd = assemble_dense(scale, KF, grid.nn, dof=1)
    got = apply_hex_operator(
        jnp.asarray(u), jnp.asarray(scale), jnp.asarray(KF)
    )
    np.testing.assert_allclose(
        np.asarray(got).ravel(), Kd @ u.ravel(), rtol=1e-10
    )


# odd, non-cubic grids (node counts), each axis at least 2 nodes
GRIDS = [(3, 4, 5), (5, 3, 4), (4, 5, 3), (2, 3, 6), (6, 2, 3)]


def _element_matrix(grid, dof):
    if dof == 3:
        return hex8_stiffness(*grid.h, NU)
    from topopt_in_petsc_tpu.models.elements import (
        helmholtz_element_matrices,
    )

    return helmholtz_element_matrices(*grid.h, R=0.05)[0]


def _case(nn, dof, seed):
    grid = Grid(nn=nn, lo=(0, 0, 0), hi=(0.3 * nn[0], 0.25 * nn[1],
                                         0.2 * nn[2]))
    rng = np.random.default_rng(seed)
    scale = rng.uniform(1e-3, 1.0, size=grid.ne)
    u = rng.normal(size=(*nn, dof))
    KE = _element_matrix(grid, dof)
    return grid, KE, scale, u, assemble_dense(scale, KE, nn, dof=dof)


@pytest.mark.parametrize("dof", [1, 3])
@pytest.mark.parametrize("nn", GRIDS)
def test_apply_matches_dense_grids(nn, dof):
    grid, KE, scale, u, Kd = _case(nn, dof, seed=sum(nn) + dof)
    got = apply_hex_operator(
        jnp.asarray(u), jnp.asarray(scale), jnp.asarray(KE)
    )
    np.testing.assert_allclose(
        np.asarray(got).ravel(), Kd @ u.ravel(), rtol=1e-10, atol=1e-12
    )


@pytest.mark.parametrize("dof", [1, 3])
@pytest.mark.parametrize("nn", GRIDS)
def test_diagonal_matches_dense_grids(nn, dof):
    grid, KE, scale, u, Kd = _case(nn, dof, seed=7 * sum(nn) + dof)
    got = hex_operator_diagonal(jnp.asarray(scale), jnp.asarray(KE), nn)
    np.testing.assert_allclose(
        np.asarray(got).ravel(), np.diag(Kd), rtol=1e-10
    )


@pytest.mark.parametrize("nn", GRIDS)
def test_absrowsum_stencil_matches_gather_form(nn):
    """The 8-tap absolute-row-sum stencil (Gershgorin input) equals the
    gather form applied to ones with |KE|, and the dense |K| row sums."""
    from topopt_in_petsc_tpu.ops.hex_operator import (
        hex_operator_absrowsum,
    )

    grid, KE, scale, u, Kd = _case(nn, 3, seed=3 * sum(nn))
    KEj = jnp.asarray(KE)
    ref = apply_hex_operator(
        jnp.ones((*nn, 3)), jnp.asarray(scale), jnp.abs(KEj)
    )
    got = hex_operator_absrowsum(jnp.asarray(scale), KEj, nn)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-10)
    # |K| row sums bound the element-wise sums from above
    assert np.all(np.asarray(got).ravel() >= np.abs(Kd).sum(1) - 1e-9)
