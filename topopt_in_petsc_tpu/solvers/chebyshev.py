"""Chebyshev polynomial smoother with Jacobi (diagonal) scaling.

The reference smooths each multigrid level with GMRES(4)+SOR
(LinearElasticity.cc:734-746) and its own comments recommend Chebyshev for
SPD problems (cc:739-745).  SOR is inherently sequential (forward sweeps over
rows) and a poor fit for data-parallel hardware; Chebyshev-Jacobi is the
standard GPU-friendly smoother: it is matrix-free (only needs K@v and
diag(K)), embarrassingly parallel, and — unlike GMRES/SOR — a *fixed linear
operator*, which keeps the V-cycle a symmetric positive definite
preconditioner so plain CG stays valid on the outside.

Smoothing band: [cheby_lower * lmax, cheby_upper * lmax] with lmax from the
CERTAIN Gershgorin-style bound (`gershgorin_lambda_max`) — power iteration
(`estimate_lambda_max`, kept as a diagnostic/test utility only) can
underestimate at high SIMP contrast, which makes the smoother amplify top
modes and diverges f32 solves.  PETSc's ksp_chebyshev_esteig plays the same
role as the bound here.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp


def hash_field(
    shape: tuple,
    dtype,
    offsets=(0, 0, 0),
) -> jax.Array:
    """Deterministic pseudo-random nodal field from *global* node indices.

    Used as the power-iteration start vector: because values depend only on
    global coordinates, single-device and SPMD (overlapping-block) runs see
    bit-identical fields, and duplicated halo planes are automatically
    consistent.  shape = (nx, ny, nz, dof); offsets = global index of the
    local block origin (0 on a single device).
    """
    i = jax.lax.broadcasted_iota(jnp.int32, shape, 0) + offsets[0]
    j = jax.lax.broadcasted_iota(jnp.int32, shape, 1) + offsets[1]
    k = jax.lax.broadcasted_iota(jnp.int32, shape, 2) + offsets[2]
    d = jax.lax.broadcasted_iota(jnp.int32, shape, 3)
    phase = (
        0.0599 * i.astype(dtype)
        + 0.2330 * j.astype(dtype)
        + 0.7190 * k.astype(dtype)
        + 0.1010 * d.astype(dtype)
    )
    r = jnp.sin(phase) * 43758.5453
    return 0.5 + 0.5 * (r - jnp.floor(r))  # in [0.5, 1.0)


def _default_dot(a, b):
    return jnp.vdot(a.ravel(), b.ravel())


def gershgorin_lambda_max(
    abs_rowsum: jax.Array,
    diag: jax.Array,
    mask: jax.Array | None = None,
) -> jax.Array:
    """Certain upper bound on lambda_max(D^-1 A) from absolute row sums.

    For the hex operator, sum_j |A_ij| <= R_i where R is one application of
    the operator with |KE| to the all-ones vector (entrywise triangle
    inequality over the element sums); then lambda_max <= max_i R_i / D_i.
    Unlike power iteration this cannot underestimate — an underestimated
    Chebyshev band makes the smoother *amplify* top modes and diverges the
    whole solve at high SIMP contrast in f32 (observed at Emax/Emin=1e9).
    Masked (Dirichlet) rows are identity: ratio 1.
    """
    ratio = abs_rowsum / diag
    if mask is not None:
        ratio = jnp.where(mask > 0, ratio, 1.0)
    return jnp.max(ratio)


def estimate_lambda_max(
    A: Callable[[jax.Array], jax.Array],
    dinv: jax.Array,
    shape: tuple,
    dtype,
    iters: int = 12,
    safety: float = 1.05,
    dot: Optional[Callable] = None,
    v0: Optional[jax.Array] = None,
) -> jax.Array:
    """Largest eigenvalue of D^-1 A by power iteration (diagnostic/test
    utility; production setup uses `gershgorin_lambda_max`, see module
    docstring).

    Uses the D-inner-product Rayleigh quotient (v.Av)/(v.Dv), which is the
    Rayleigh quotient of the symmetric pencil (A, D), so the estimate is a
    lower bound converging from below; `safety` compensates.

    `dot` must be the globally-correct inner product (ownership-weighted +
    psum in SPMD mode); `v0` a start vector consistent across shards.
    """
    if dot is None:
        dot = _default_dot
    v = hash_field(shape, dtype) if v0 is None else v0

    def body(_, v):
        w = dinv * A(v)
        return w / jnp.sqrt(dot(w, w))

    v = jax.lax.fori_loop(0, iters, body, v)
    Av = A(v)
    num = dot(v, Av)
    den = dot(v, v / dinv)
    return safety * num / den


def chebyshev_smooth(
    A: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x: jax.Array,
    dinv: jax.Array,
    lmax: jax.Array,
    *,
    degree: int = 4,
    lower: float = 0.1,
    upper: float = 1.1,
    x_is_zero: bool = False,
) -> jax.Array:
    """`degree` Chebyshev iterations targeting D^-1 A in [lower, upper]*lmax.

    Classical three-term recurrence (Saad, Iterative Methods §12.3 /
    hypre-style), maintaining the true residual.  A fixed polynomial in
    (D^-1 A) applied to the residual: linear, SPD-compatible.

    `x_is_zero=True` declares the initial guess zero (V-cycle
    presmoothing): the initial residual is just `b`, skipping one full
    operator application — the kernel call is opaque to XLA, so A(0)
    would otherwise really execute — and one live vector.
    """
    # harmonize scalar dtypes with the field dtype (the bf16 V-cycle
    # passes bf16 fields with an f32 eigenvalue bound; nudge the bound up
    # so the low-precision rounding cannot shrink it below lambda_max)
    lmax = (jnp.asarray(lmax) * 1.01).astype(b.dtype)
    lmin = jnp.asarray(lower, b.dtype) * lmax
    lmax_b = jnp.asarray(upper, b.dtype) * lmax
    theta = 0.5 * (lmax_b + lmin)
    delta = 0.5 * (lmax_b - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma

    r = b if x_is_zero else b - A(x)
    d = (dinv * r) / theta
    x = d if x_is_zero else x + d

    def body(_, carry):
        x, r, d, rho = carry
        r = r - A(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (dinv * r)
        x = x + d
        return (x, r, d, rho_new)

    x, _, _, _ = jax.lax.fori_loop(0, degree - 1, body, (x, r, d, rho))
    return x
