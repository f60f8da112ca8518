"""Matrix-free structured-grid hex FEM operator.

JAX replacement for the reference's assembled sparse stiffness matrix
and its SpMV: instead of MatSetValuesLocal element assembly + MatMult
(LinearElasticity.cc:487-549, 204), we express `K(x) @ u` directly as

    1. *gather*  — 8 static shifted slices collect each element's corner
       dofs into an ``(ex, ey, ez, 8*dof)`` tensor (no indexing arrays; the
       structured grid makes connectivity implicit, so the reference's
       DMDAGetElements_3D helper has no equivalent here),
    2. *matmul*  — one large ``(nelem, 8*dof) x (8*dof, 8*dof)`` contraction
       against the constant element matrix with the per-element SIMP scale
       fused in,
    3. *scatter* — 8 static shifted `.at[...].add` updates accumulate corner
       forces back to nodes (pure adds of disjoint slabs per corner).

This is the plain reference form and the CPU path; on a GPU the fused
node-centric kernel of ops/hex_triton.py replaces it for float32 solves
(ops/select.py).

Halo exchange: the SPMD engine (parallel/spmd.py) completes the local
result across device blocks with explicit ppermute plane exchanges — the
DMGlobalToLocal ghost exchange of the reference (LinearElasticity.cc:249).

All functions are shape-polymorphic in dof (3 for elasticity, 1 for the
Helmholtz PDE filter) and jit/grad-compatible.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from topopt_in_petsc_tpu.grid import CORNER_OFFSETS


def _corner_slice(u: jax.Array, corner: int) -> jax.Array:
    """Element-grid view of nodal field `u` at a given hex corner."""
    ox, oy, oz = CORNER_OFFSETS[corner]
    ex, ey, ez = u.shape[0] - 1, u.shape[1] - 1, u.shape[2] - 1
    return u[ox : ox + ex, oy : oy + ey, oz : oz + ez]


def gather_element_dofs(u: jax.Array) -> jax.Array:
    """(nx, ny, nz, dof) nodal field -> (ex, ey, ez, 8*dof) element dofs.

    Concatenation order matches the reference edof ordering
    (LinearElasticity.cc:263-267): corner-major, dof-minor.
    """
    return jnp.concatenate(
        [_corner_slice(u, c) for c in range(8)], axis=-1
    )


def scatter_element_dofs(
    fe: jax.Array, nn: tuple[int, int, int]
) -> jax.Array:
    """(ex, ey, ez, 8*dof) element values -> (nx, ny, nz, dof) nodal sum.

    Adjoint of `gather_element_dofs` (the FEM scatter-add).
    """
    ex, ey, ez, k = fe.shape
    dof = k // 8
    out = jnp.zeros((nn[0], nn[1], nn[2], dof), dtype=fe.dtype)
    for c, (ox, oy, oz) in enumerate(CORNER_OFFSETS):
        out = out.at[ox : ox + ex, oy : oy + ey, oz : oz + ez].add(
            fe[..., c * dof : (c + 1) * dof]
        )
    return out


def apply_hex_operator(
    u: jax.Array,
    scale: jax.Array,
    KE: jax.Array,
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """Matrix-free `K @ u` with per-element scaling.

        K = sum_e  scale_e * (S_e^T KE S_e)

    u:     (nx, ny, nz, dof) nodal field
    scale: (ex, ey, ez) per-element coefficient (SIMP-interpolated E, or 1)
    KE:    (8*dof, 8*dof) constant element matrix

    Equivalent to AssembleStiffnessMatrix + MatMult of the reference
    (LinearElasticity.cc:487-549) fused into one pass.
    """
    ue = gather_element_dofs(u)
    # Scale before the contraction: scalar per element commutes with KE.
    # precision HIGHEST: a float32 product may otherwise run in TF32
    # (~1e-3 relative error), too coarse for the outer Krylov residual.
    fe = jnp.einsum(
        "...i,ij->...j",
        ue * scale[..., None],
        KE,
        preferred_element_type=u.dtype,
        precision=precision,
    )
    nn = (u.shape[0], u.shape[1], u.shape[2])
    return scatter_element_dofs(fe, nn)


def hex_operator_diagonal(
    scale: jax.Array, KE: jax.Array, nn: tuple[int, int, int]
) -> jax.Array:
    """diag(K) as an (nx, ny, nz, dof) field (for Jacobi/Chebyshev).

    Node n receives, from each adjacent element having n at local corner c,
    the diagonal block entries KE[c*dof+d, c*dof+d] times that element's
    scale.
    """
    dof = KE.shape[0] // 8
    ke_diag = jnp.diagonal(KE).reshape(8, dof)  # (corner, dof)
    ex, ey, ez = scale.shape
    out = jnp.zeros((nn[0], nn[1], nn[2], dof), dtype=scale.dtype)
    for c, (ox, oy, oz) in enumerate(CORNER_OFFSETS):
        out = out.at[ox : ox + ex, oy : oy + ey, oz : oz + ez].add(
            scale[..., None] * ke_diag[c][None, None, None, :]
        )
    return out


def hex_operator_absrowsum(
    scale: jax.Array, KE: jax.Array, nn: tuple[int, int, int]
) -> jax.Array:
    """sum_j |K_ij| as an (nx, ny, nz, dof) field — the Gershgorin bound
    input (solvers/chebyshev.gershgorin_lambda_max).

    Equivalent to `apply_hex_operator(ones, scale, |KE|)` but as an 8-tap
    stencil on the element scale (row sums of |KE| are constants), with
    no (nelem, 8*dof) gather transient.  Requires scale >= 0 (SIMP scales
    are)."""
    dof = KE.shape[0] // 8
    ke_rows = jnp.sum(jnp.abs(KE), axis=1).reshape(8, dof)  # (corner, dof)
    ex, ey, ez = scale.shape
    out = jnp.zeros((nn[0], nn[1], nn[2], dof), dtype=scale.dtype)
    for c, (ox, oy, oz) in enumerate(CORNER_OFFSETS):
        out = out.at[ox : ox + ex, oy : oy + ey, oz : oz + ez].add(
            scale[..., None] * ke_rows[c][None, None, None, :]
        )
    return out


def element_quadratic_form(u: jax.Array, KE: jax.Array) -> jax.Array:
    """Per-element quadratic form  q_e = u_e^T KE u_e  -> (ex, ey, ez).

    The uKu loop of the objective/sensitivity computation
    (LinearElasticity.cc:405-424), vectorized.
    """
    ue = gather_element_dofs(u)
    w = jnp.einsum(
        "...i,ij->...j",
        ue,
        KE,
        preferred_element_type=u.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.sum(w * ue, axis=-1)


def octant_split(E: jax.Array) -> jax.Array:
    """(2ex, 2ey, 2ez) child-element field -> (8, ex, ey, ez) octant views
    (strided subsampling in CORNER_OFFSETS order)."""
    return jnp.stack(
        [E[ox::2, oy::2, oz::2] for (ox, oy, oz) in CORNER_OFFSETS]
    )


def apply_hex_operator_octant(
    u: jax.Array,
    octants: jax.Array,
    KEps: jax.Array,
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """Matrix-free apply of a Galerkin-coarsened operator:

        K = sum_C S_C^T ( sum_p octants[p, C] * KEps[p] ) S_C

    u:       (nx, ny, nz, dof) coarse nodal field
    octants: (8, ex, ey, ez) per-element octant weights (child densities
             or octant-averaged descendants)
    KEps:    (8, 8*dof, 8*dof) constant octant matrices
             (galerkin_octant_matrices)
    """
    ue = gather_element_dofs(u)
    z = jnp.einsum(
        "...i,pij->p...j",
        ue,
        KEps,
        preferred_element_type=u.dtype,
        precision=precision,
    )
    fe = jnp.einsum("p...,p...j->...j", octants, z)
    nn = (u.shape[0], u.shape[1], u.shape[2])
    return scatter_element_dofs(fe, nn)


def hex_operator_diagonal_octant(
    octants: jax.Array, KEps: jax.Array, nn: tuple[int, int, int]
) -> jax.Array:
    """diag(K) for the octant-Galerkin operator."""
    dof = KEps.shape[1] // 8
    ke_diag = jnp.stack(
        [jnp.diagonal(KEps[p]).reshape(8, dof) for p in range(8)]
    )  # (p, corner, dof)
    ex, ey, ez = octants.shape[1:]
    out = jnp.zeros((nn[0], nn[1], nn[2], dof), dtype=octants.dtype)
    for c, (ox, oy, oz) in enumerate(CORNER_OFFSETS):
        contrib = jnp.einsum(
            "p...,pd->...d", octants, ke_diag[:, c, :]
        )
        out = out.at[ox : ox + ex, oy : oy + ey, oz : oz + ez].add(contrib)
    return out


def assemble_dense(
    scale: np.ndarray, KE: np.ndarray, nn: tuple[int, int, int], dof: int
) -> np.ndarray:
    """Dense assembled K for cross-checking on tiny grids (test-only).

    Independent element-loop assembly in numpy, used by the test-suite to
    validate the matrix-free path against explicit assembly (the SURVEY §4
    strategy; the reference itself has no tests).
    """
    nx, ny, nz = nn
    ndof = nx * ny * nz * dof
    K = np.zeros((ndof, ndof))

    def node_id(i, j, k):
        return (i * ny + j) * nz + k

    ex, ey, ez = nx - 1, ny - 1, nz - 1
    for i in range(ex):
        for j in range(ey):
            for k in range(ez):
                edof = []
                for (ox, oy, oz) in CORNER_OFFSETS:
                    n = node_id(i + ox, j + oy, k + oz)
                    edof.extend(range(dof * n, dof * n + dof))
                edof = np.array(edof)
                K[np.ix_(edof, edof)] += scale[i, j, k] * KE
    return K
