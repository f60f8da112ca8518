"""Preconditioned (flexible) conjugate gradients.

JAX replacement for the reference's outer Krylov loop.  The reference
uses FGMRES(100) (LinearElasticity.cc:638-650) because its V-cycle smoothers
(GMRES+SOR) make the preconditioner nonstationary; the stiffness matrix K is
SPD after the symmetric Dirichlet treatment K <- N'KN + (I-N)
(LinearElasticity.cc:530-538), so with an SPD multigrid preconditioner the
natural Krylov method is CG: short recurrences (no Arnoldi basis of 100
vectors in device memory), two dots per iteration (psum over the mesh).
The flexible (Polak-Ribiere / IPCG) variant is the default, which tolerates
the slight nonstationarity introduced by a CG coarse-level solve, the same
robustness role FGMRES plays in the reference.

Everything runs inside `lax.while_loop` (jit-compatible, no host syncs);
dot products optionally accumulate in float64 (the reference is all-f64
PETSc; we keep f32 fields + f64 reductions to match its convergence
behavior at rtol 1e-5).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


_DOT_CHUNK = 131072


def _dot(a: jax.Array, b: jax.Array, precise: bool) -> jax.Array:
    """Inner product with optional high-accuracy accumulation.

    The 'precise' path is a two-stage reduction: float32 partial dots
    (over the minor axes, or over 128K-element chunks of a flat
    vector), then a float64 sum of the partials — no full-size float64
    copies of the operands.
    """
    if precise and a.dtype != jnp.float64 and a.ndim >= 2:
        # reduce over the minor axes in one fused pass (no ravel of the
        # 4D field), then widen across the leading-axis partials
        axes = list(range(a.ndim))
        parts = jnp.einsum(
            a, axes, b, axes, [0],
            precision=jax.lax.Precision.HIGHEST,
        )
        return jnp.sum(parts, dtype=jnp.float64)
    af, bf = a.ravel(), b.ravel()
    if precise and af.dtype != jnp.float64:
        n = af.size
        m = (n // _DOT_CHUNK) * _DOT_CHUNK
        s = jnp.zeros((), jnp.float64)
        if m:
            parts = jnp.einsum(
                "ij,ij->i",
                af[:m].reshape(-1, _DOT_CHUNK),
                bf[:m].reshape(-1, _DOT_CHUNK),
                precision=jax.lax.Precision.HIGHEST,
            )
            s = s + jnp.sum(parts, dtype=jnp.float64)
        if n - m:
            s = s + jnp.vdot(af[m:], bf[m:]).astype(jnp.float64)
        return s
    return jnp.vdot(af, bf)


def accurate_sum(v: jax.Array, precise: bool = True) -> jax.Array:
    """Chunked two-stage sum; same form as the precise _dot (no
    full-size f64 transients)."""
    if precise and v.dtype != jnp.float64 and v.ndim >= 2:
        parts = jnp.sum(v, axis=tuple(range(1, v.ndim)))
        return jnp.sum(parts, dtype=jnp.float64)
    vf = v.ravel()
    if not precise or vf.dtype == jnp.float64:
        return jnp.sum(vf)
    n = vf.size
    m = (n // _DOT_CHUNK) * _DOT_CHUNK
    s = jnp.zeros((), jnp.float64)
    if m:
        parts = jnp.sum(vf[:m].reshape(-1, _DOT_CHUNK), axis=1)
        s = s + jnp.sum(parts, dtype=jnp.float64)
    if n - m:
        s = s + jnp.sum(vf[m:]).astype(jnp.float64)
    return s


class CGResult(NamedTuple):
    x: jax.Array
    iters: jax.Array  # int32
    relres: jax.Array  # final ||r|| / ||b||


class PCGState(NamedTuple):
    """The Krylov loop carry."""

    x: jax.Array
    r: jax.Array
    p: jax.Array
    rz: jax.Array
    rnorm: jax.Array
    bnorm: jax.Array
    k: jax.Array


def pcg(
    A: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array,
    M: Callable[[jax.Array], jax.Array] | None = None,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 200,
    flexible: bool = True,
    precise_dots: bool = True,
    dot: Callable | None = None,
) -> CGResult:
    """Solve A x = b with preconditioned CG, nonzero initial guess.

    Matches the reference solver contract (LinearElasticity.cc:619-647):
    rtol 1e-5, maxit 200, initial guess nonzero, convergence on the
    preconditioned... here on the true residual 2-norm vs ||b||.

    `dot`, when given, replaces the inner product (the SPMD engine passes
    an ownership-weighted psum dot so duplicated halo planes count once).

    Flexible (Polak-Ribiere) beta is computed as z.(r_new - r_old)
    = -alpha * z.Ap — the identity lets the old residual die before the
    preconditioner runs, so only Ap stays live across M (one fewer
    full-precision vector at the peak).
    """
    if M is None:
        M = lambda r: r

    if dot is None:
        dot = partial(_dot, precise=precise_dots)

    r = b - A(x0)
    z = M(r)
    rz = dot(r, z)
    bnorm = jnp.sqrt(dot(b, b))
    rnorm0 = jnp.sqrt(dot(r, r))
    init = PCGState(x0, r, z, rz, rnorm0, bnorm, jnp.asarray(0, jnp.int32))
    tol = jnp.maximum(rtol * init.bnorm, atol)

    # NOTE: z is intentionally NOT part of the loop carry — the body
    # never reads the previous z, and every carried vector costs a live
    # buffer across the whole solve.

    def cond(s: PCGState):
        return jnp.logical_and(s.k < maxiter, s.rnorm > tol)

    def body(s: PCGState):
        vdt = s.x.dtype
        p = s.p
        Ap = A(p)
        pAp = dot(p, Ap)
        alpha = (s.rz / pAp).astype(vdt)
        x = s.x + alpha * p
        r = s.r - alpha * Ap
        z = M(r)
        if flexible:
            # Polak-Ribiere (robust to slightly nonstationary M) via
            # r_new - r_old = -alpha*Ap: s.r dies before M runs.
            beta_num = -alpha * dot(z, Ap)
        else:
            beta_num = dot(z, r)
        rz = dot(r, z)
        beta = (beta_num / s.rz).astype(vdt)
        p = z + beta * p
        rnorm = jnp.sqrt(dot(r, r))
        return PCGState(x, r, p, rz, rnorm, s.bnorm, s.k + 1)

    final = jax.lax.while_loop(cond, body, init)
    res = CGResult(
        x=final.x,
        iters=final.k,
        relres=final.rnorm / jnp.maximum(final.bnorm, 1e-300),
    )
    return res
