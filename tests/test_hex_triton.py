"""The fused hex-operator kernel (ops/hex_triton.py) against the plain
XLA reference `apply_hex_operator`: in the Pallas interpreter on the CPU,
and compiled on a GPU (tests marked `gpu`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topopt_in_petsc_tpu.grid import Grid
from topopt_in_petsc_tpu.models.elements import (
    helmholtz_element_matrices,
    hex8_stiffness,
)
from topopt_in_petsc_tpu.ops.hex_operator import apply_hex_operator
from topopt_in_petsc_tpu.ops.hex_triton import make_triton_hex_apply

SMALL_BLOCK = (4, 8)  # several tiles and ragged edges at these sizes


def _KE(nn, dof):
    grid = Grid(nn=nn, lo=(0, 0, 0), hi=(2.0, 1.0, 0.7))
    if dof == 3:
        return hex8_stiffness(*grid.h, 0.3)
    return helmholtz_element_matrices(*grid.h, R=0.1)[0]


def _check(nn, dof, E, block=SMALL_BLOCK, seed=0):
    KE = _KE(nn, dof)
    u = np.random.default_rng(seed).normal(size=(*nn, dof))
    ref = np.asarray(apply_hex_operator(
        jnp.asarray(u), jnp.asarray(E), jnp.asarray(KE)
    ))
    ap = make_triton_hex_apply(KE, block=block, interpret=True)
    got = np.asarray(jax.jit(ap)(
        jnp.asarray(u, jnp.float32), jnp.asarray(E, jnp.float32)
    ), np.float64)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-5 * scale
    assert np.linalg.norm(got - ref) <= 2e-6 * np.linalg.norm(ref)


@pytest.mark.parametrize("dof", [1, 3])
@pytest.mark.parametrize(
    "nn", [(9, 7, 5), (6, 11, 13), (5, 5, 34), (3, 3, 3), (2, 9, 4)]
)
def test_kernel_matches_reference(nn, dof):
    E = np.random.default_rng(1).uniform(1e-9, 1.0,
                                         size=tuple(n - 1 for n in nn))
    _check(nn, dof, E)


@pytest.mark.parametrize("kind", ["uniform", "binary", "ones", "checker"])
def test_kernel_element_contrast(kind):
    nn = (9, 7, 5)
    ne = tuple(n - 1 for n in nn)
    rng = np.random.default_rng(2)
    if kind == "uniform":
        E = rng.uniform(1e-9, 1.0, size=ne)
    elif kind == "binary":  # SIMP extremes: void 1e-9, solid 1
        E = np.where(rng.uniform(size=ne) < 0.3, 1.0, 1e-9)
    elif kind == "ones":
        E = np.ones(ne)
    else:
        i, j, k = np.indices(ne)
        E = np.where((i + j + k) % 2 == 0, 1.0, 1e-9)
    _check(nn, 3, E)


@pytest.mark.parametrize("block", [(1, 8), (2, 4), (4, 32), (8, 32)])
def test_kernel_tile_shapes(block):
    nn = (6, 11, 13)
    E = np.random.default_rng(3).uniform(0.1, 1.0,
                                         size=tuple(n - 1 for n in nn))
    _check(nn, 3, E, block=block)


def test_kernel_rejects_mismatched_shapes():
    ap = make_triton_hex_apply(_KE((5, 5, 5), 3), interpret=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        ap(jnp.zeros((5, 5, 5, 3), jnp.float32),
           jnp.zeros((5, 5, 5), jnp.float32))
    with pytest.raises(ValueError, match="shape mismatch"):
        ap(jnp.zeros((5, 5, 5, 1), jnp.float32),
           jnp.zeros((4, 4, 4), jnp.float32))


def test_kernel_as_multigrid_fine_level():
    """The kernel as the MG fine level and outer Krylov operator gives
    the XLA path's solution."""
    from topopt_in_petsc_tpu.config import TopOptConfig
    from topopt_in_petsc_tpu.models.elasticity import LinearElasticity

    cfg = TopOptConfig(nx=9, ny=5, nz=5, nlvls=2, dtype="float32",
                       ksp_rtol=1e-6)
    cfg.validate()
    x = jnp.asarray(np.random.default_rng(4).uniform(
        0.2, 1.0, size=(8, 4, 4)), jnp.float32)
    ref = LinearElasticity(cfg).solve_state(x)
    phys = LinearElasticity(cfg)
    phys.mg.fine_apply = make_triton_hex_apply(
        hex8_stiffness(*phys.grid.h, cfg.nu), block=SMALL_BLOCK,
        interpret=True,
    )
    got = phys.solve_state(x)
    assert float(got.relres) < 1e-6
    assert abs(int(got.iters) - int(ref.iters)) <= 1
    scale = float(jnp.max(jnp.abs(ref.x)))
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("nn", [(65, 33, 33), (129, 129, 129)])
def test_kernel_compiled_matches_reference(gpu, nn):
    KE = _KE(nn, 3)
    ku, ke = jax.random.split(jax.random.PRNGKey(0))
    u = jax.random.normal(ku, (*nn, 3), jnp.float64)
    E = jax.random.uniform(ke, tuple(n - 1 for n in nn), jnp.float64,
                           minval=1e-9, maxval=1.0)
    ref = apply_hex_operator(u, E, jnp.asarray(KE))
    got = jax.jit(make_triton_hex_apply(KE))(
        u.astype(jnp.float32), E.astype(jnp.float32)
    ).astype(jnp.float64)
    assert float(jnp.linalg.norm((got - ref).ravel())) <= \
        2e-6 * float(jnp.linalg.norm(ref.ravel()))
    assert float(jnp.max(jnp.abs(got - ref))) <= \
        1e-5 * float(jnp.max(jnp.abs(ref)))
